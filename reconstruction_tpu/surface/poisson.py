"""Screened Poisson surface reconstruction on a dense multigrid.

Replaces the external `PoissonRecon.x64.exe --depth 9 --samplesPerNode 2
--pointWeight 0 --solverDivide 9` (`Demo/mesh.bat:1`) and meshlab's global
Poisson (octree depth 10, `Demo/meshlab/script1.mlx`).  The reference
shells out to adaptive-octree CPU solvers; the array equivalent is a
dense regular grid (SURVEY.md section 7 hard part (d)) where every step is
a stencil:

  1. trilinear splat of the oriented normals -> vector field V, plus a
     sample-density grid used later for trimming,
  2. f = div V (central differences),
  3. a SPECTRAL solve of Delta chi = f: the periodic discrete Laplacian
     diagonalizes under the 3D FFT, so the solve is one rfftn / irfftn
     round trip — exact and iteration-free.  The padded domain boundary is uniformly
     "outside" the shape, so the periodic wrap is benign,
  4. isovalue = density-weighted mean of chi at the samples
     (Kazhdan's isosurface selection).

With --pointWeight 0 the reference runs UNSCREENED Poisson; the screened
variant (spatially varying weight) is handled by a short fixed-point
loop re-using the spectral solve as its preconditioner-exact inner step.
A multigrid V-cycle (weighted Jacobi + trilinear prolongation) is kept
for halo-exchange distributed operation where a global FFT is
undesirable (see parallel/).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class PoissonResult(NamedTuple):
    chi: jnp.ndarray        # (R, R, R) implicit function
    iso: jnp.ndarray        # scalar isovalue
    density: jnp.ndarray    # (R, R, R) splat density (for trimming)
    origin: jnp.ndarray     # (3,) world coords of voxel (0,0,0)
    spacing: jnp.ndarray    # scalar voxel size


def _splat3(grid: jnp.ndarray, idx: jnp.ndarray, w: jnp.ndarray,
            vals: jnp.ndarray) -> jnp.ndarray:
    """Trilinear scatter-add of vals (N, C) at fractional idx (N, 3)."""
    i0 = jnp.floor(idx).astype(jnp.int32)
    f = idx - i0
    R = grid.shape[0]
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ii = i0 + jnp.array([dx, dy, dz], jnp.int32)
                wq = (jnp.where(dx, f[:, 0], 1 - f[:, 0])
                      * jnp.where(dy, f[:, 1], 1 - f[:, 1])
                      * jnp.where(dz, f[:, 2], 1 - f[:, 2])) * w
                ii = jnp.clip(ii, 0, R - 1)
                if vals.ndim == 1:
                    grid = grid.at[ii[:, 0], ii[:, 1], ii[:, 2]].add(wq * vals)
                else:
                    grid = grid.at[ii[:, 0], ii[:, 1], ii[:, 2]].add(
                        wq[:, None] * vals)
    return grid


def _shift3(a, axis, d):
    """Zero-padded shift along one axis: out[i] = a[i + d]."""
    pads = [(0, 0)] * 3
    pads[axis] = (max(-d, 0), max(d, 0))
    ap = jnp.pad(a, pads)
    sl = [slice(None)] * 3
    n = a.shape[axis]
    start = max(d, 0)
    sl[axis] = slice(start, start + n)
    return ap[tuple(sl)]


def _laplacian(x):
    out = -6.0 * x
    for ax in range(3):
        out = out + _shift3(x, ax, 1) + _shift3(x, ax, -1)
    return out


def _jacobi(x, f, screen, n_iter):
    """Weighted Jacobi for (Delta - screen) x = f."""
    omega = 2.0 / 3.0
    diag = -6.0 - screen

    def body(_, x):
        nb = jnp.zeros_like(x)
        for ax in range(3):
            nb = nb + _shift3(x, ax, 1) + _shift3(x, ax, -1)
        x_new = (f - nb) / diag
        return x + omega * (x_new - x)

    return jax.lax.fori_loop(0, n_iter, body, x)


def _restrict(x):
    """Full-weighting 2x restriction (trilinear average of 8 children)."""
    R = x.shape[0]
    return x.reshape(R // 2, 2, R // 2, 2, R // 2, 2).mean(axis=(1, 3, 5))


def _prolong(x):
    """Cell-centered trilinear prolongation: fine sample 2i gets
    0.75 c_i + 0.25 c_{i-1}, fine 2i+1 gets 0.75 c_i + 0.25 c_{i+1}
    (separable per axis; zero beyond the boundary)."""
    for ax in range(3):
        lo = 0.75 * x + 0.25 * _shift3_nd(x, ax, -1)
        hi = 0.75 * x + 0.25 * _shift3_nd(x, ax, 1)
        x = _interleave(lo, hi, ax)
    return x


def _shift3_nd(a, axis, d):
    return _shift3(a, axis, d) if a.ndim == 3 else a


def _interleave(lo, hi, axis):
    stacked = jnp.stack([lo, hi], axis=axis + 1)
    shape = list(lo.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _vcycle(x, f, screen, levels, pre, post):
    if levels == 0 or x.shape[0] <= 4:
        return _jacobi(x, f, screen, 40)
    x = _jacobi(x, f, screen, pre)
    r = f - (_laplacian(x) - screen * x)
    r2 = _restrict(r) * 4.0  # h^2 scaling: coarse h = 2h
    e2 = jnp.zeros_like(r2)
    e2 = _vcycle(e2, r2, _restrict(screen) * 4.0, levels - 1, pre, post)
    x = x + _prolong(e2)
    x = _jacobi(x, f, screen, post)
    return x


def _spectral_inv_laplacian(f: jnp.ndarray) -> jnp.ndarray:
    """Exact solve of the periodic 7-point Laplacian: chi = Delta^-1 f,
    zero-mean convention (k=0 mode dropped)."""
    R = f.shape[0]
    fh = jnp.fft.rfftn(f)
    k = jnp.arange(R)
    lam1 = 2.0 * jnp.cos(2.0 * jnp.pi * k / R) - 2.0         # (R,)
    kr = jnp.arange(R // 2 + 1)
    lam_r = 2.0 * jnp.cos(2.0 * jnp.pi * kr / R) - 2.0       # (R//2+1,)
    lam = (lam1[:, None, None] + lam1[None, :, None] + lam_r[None, None, :])
    inv = jnp.where(lam < -1e-12, 1.0 / jnp.where(lam < -1e-12, lam, 1.0), 0.0)
    return jnp.fft.irfftn(fh * inv, s=f.shape)


@partial(jax.jit, static_argnames=("resolution", "cycles", "pre", "post",
                                   "point_weight"))
def poisson_reconstruct(
    points: jnp.ndarray,
    normals: jnp.ndarray,
    valid: jnp.ndarray,
    resolution: int = 128,
    cycles: int = 8,
    pre: int = 2,
    post: int = 2,
    point_weight: float = 0.0,
    pad_frac: float = 0.1,
) -> PoissonResult:
    """Solve for the implicit function on a resolution^3 grid."""
    R = resolution
    pts = points.astype(jnp.float32)
    big = jnp.float32(1e30)
    mn = jnp.min(jnp.where(valid[:, None], pts, big), axis=0)
    mx = jnp.max(jnp.where(valid[:, None], pts, -big), axis=0)
    ext = jnp.max(mx - mn)
    pad = ext * pad_frac
    origin = mn - pad
    spacing = (ext + 2 * pad) / (R - 1)
    gp = (pts - origin) / spacing
    w = valid.astype(jnp.float32)

    # Normal field splat (components) + density.
    V = jnp.zeros((R, R, R, 3), jnp.float32)
    nrm = jnp.where(valid[:, None], normals.astype(jnp.float32), 0.0)
    V = _splat3(V, gp, w, nrm)
    density = _splat3(jnp.zeros((R, R, R), jnp.float32), gp, w,
                      jnp.ones_like(w))

    # Divergence (central differences).
    f = jnp.zeros((R, R, R), jnp.float32)
    for ax in range(3):
        f = f + 0.5 * (_shift3(V[..., ax], ax, 1) - _shift3(V[..., ax], ax, -1))

    if point_weight == 0.0:
        x = _spectral_inv_laplacian(f)
    else:
        # Screened: (Delta - w D) chi = f; fixed point
        # chi <- Delta^-1 (f + w D chi), seeded by the unscreened solve.
        screen = jnp.float32(point_weight) * density

        def fp(_, x):
            return _spectral_inv_laplacian(f + screen * x)

        x = jax.lax.fori_loop(0, cycles, fp, _spectral_inv_laplacian(f))

    # Isovalue: density-weighted mean of chi at the samples.
    gi = jnp.clip(jnp.round(gp).astype(jnp.int32), 0, R - 1)
    chi_at = x[gi[:, 0], gi[:, 1], gi[:, 2]]
    iso = jnp.sum(chi_at * w) / jnp.maximum(jnp.sum(w), 1.0)
    return PoissonResult(chi=x, iso=iso, density=density,
                         origin=origin, spacing=spacing)

"""Normal estimation via neighborhood covariance.

Replaces PCL `NormalEstimationOMP(radius=2.5)` + the manual camera-facing
flip (`CCloudOptimization.cpp:101-121`; the reference's `setViewPoint`
call lands AFTER `compute`, `:108`, so only the manual flip matters —
reproduced here).  The 3x3 eigenproblem is solved in closed form
(trigonometric method) — batched and branch-free.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.config import GEOMETRY_PRECISION
from reconstruction_tpu.cloud.neighbors import (
    build_dense_grid, host_grid_geometry, neighbor_map_dense)


@jax.jit
def smallest_eigenvector_3x3(A: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Smallest eigenpair of symmetric (..., 3, 3) matrices.

    Trigonometric closed form (Smith's method) + cross-product
    eigenvector extraction; safe for (near-)degenerate spectra.
    Returns (eigenvalue (...,), eigenvector (..., 3) unit length).
    """
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    I = jnp.eye(3, dtype=A.dtype)
    B = A - q[..., None, None] * I
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = detB / (2.0 * p ** 3 + 1e-30)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # eigenvalues: q + 2p cos(phi + 2k pi/3); smallest at k=1 shift
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_min = jnp.where(p2 < 1e-20, q, lam_min)

    C = A - lam_min[..., None, None] * I
    # eigenvector = most-independent cross product of rows of C
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, -1)
    n02 = jnp.sum(c02 * c02, -1)
    n12 = jnp.sum(c12 * c12, -1)
    best = jnp.stack([n01, n02, n12], -1).argmax(-1)
    v = jnp.take_along_axis(
        jnp.stack([c01, c02, c12], -2), best[..., None, None], axis=-2
    )[..., 0, :]
    nv = jnp.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.where(nv > 1e-20, v / jnp.maximum(nv, 1e-30),
                  jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], A.dtype), v.shape))
    return lam_min, v


def _cov_stat(q, cand, cpts, d2, ok):
    """Neighborhood covariance reduced in the candidate stream (the
    (M, K, 3) gather would cost GBs at production point counts)."""
    w = ok.astype(jnp.float32)                      # (c, K)
    cnt = jnp.maximum(w.sum(-1, keepdims=True), 1.0)
    mean = (cpts * w[..., None]).sum(-2) / cnt
    d = jnp.where(ok[..., None], cpts - mean[:, None, :], 0.0)
    return (jnp.einsum("nki,nkj->nij", d, d, precision=GEOMETRY_PRECISION)
            / cnt[..., None])


def estimate_normals(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float,
    viewpoint: jnp.ndarray,
    per_cell: int = 8,
    chunk: int = 4096,
    host_points: np.ndarray | None = None,
    host_valid: np.ndarray | None = None,
    backend: str = "auto",
) -> jnp.ndarray:
    """Covariance normals within ``radius``, flipped toward ``viewpoint``
    (the pair's camera center, `CCloudOptimization.cpp:117-120`).

    host_points/host_valid: optional host copies for sync-free grid
    geometry (see sor_filter).  host_valid may be a SUPERSET of the
    device ``valid`` mask (e.g. the pre-SOR validity): the bbox only
    needs to cover the queries, and the quantile box guards outliers.

    backend "native" runs the C++ exact-radius path on host and returns
    a NUMPY array (zero device traffic); it needs the QUERY validity on
    host, so it uses np.asarray(valid) (cheap relative to the stage)
    unless valid is already host-resident.
    """
    from reconstruction_tpu.cloud.backend import resolve_backend
    radius = float(radius)
    if resolve_backend(backend) == "native":
        from reconstruction_tpu import native
        pts_np = (np.asarray(points, np.float32) if host_points is None
                  else host_points)
        v_np = (valid if isinstance(valid, np.ndarray)
                else np.asarray(valid).astype(bool))
        return native.cloud_normals(pts_np, v_np, radius,
                                    np.asarray(viewpoint, np.float32))
    origin, dims, cell = host_grid_geometry(
        np.asarray(points) if host_points is None else host_points,
        np.asarray(valid) if host_valid is None else host_valid, radius)
    grid = build_dense_grid(points, valid, origin, cell, dims,
                            pad=per_cell)
    cov = neighbor_map_dense(grid, points, valid, radius, _cov_stat, dims,
                             per_cell=per_cell, chunk=chunk)
    return _normals_epilogue(cov, points, jnp.asarray(viewpoint, jnp.float32))


@jax.jit
def _normals_epilogue(cov, points, viewpoint):
    """Eigen + camera flip in ONE program."""
    _, normals = smallest_eigenvector_3x3(cov)
    to_cam = viewpoint[None, :] - points
    flip = jnp.sum(normals * to_cam, -1) < 0
    return jnp.where(flip[:, None], -normals, normals)

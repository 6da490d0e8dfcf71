"""Moving least squares smoothing.

Replaces PCL `MovingLeastSquaresOMP(radius=2.5, polynomial order 1,
computeNormals)` (`CCloudOptimization.cpp:350-364`): per point, a
Gaussian-weighted local plane fit over the radius neighborhood; the point
projects onto the plane, and the plane normal (re-oriented against the
pre-MLS normals, `:369-386`) becomes the output normal.  Order-1
polynomial fit == plane projection, so this matches the reference's
configuration exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from functools import lru_cache

import numpy as np

from reconstruction_tpu.config import GEOMETRY_PRECISION
from reconstruction_tpu.cloud.neighbors import (
    build_dense_grid, host_grid_geometry, neighbor_map_dense)
from reconstruction_tpu.cloud.normals import smallest_eigenvector_3x3


@lru_cache(None)
def _plane_stat(r: float):
    def fn(q, cand, cpts, d2, ok):
        """Weighted plane-fit moments reduced in the candidate stream
        (the fused global cloud runs at millions of points; materialized
        candidates would cost tens of GB)."""
        # Gaussian weights exp(-d^2 / r^2) (PCL sqr_gauss_param = r^2).
        w = jnp.where(ok, jnp.exp(-d2 / (r * r)), 0.0)
        wsum = jnp.maximum(w.sum(-1, keepdims=True), 1e-20)
        mean = (cpts * w[..., None]).sum(-2) / wsum
        d = (cpts - mean[:, None, :]) * jnp.sqrt(w)[..., None]
        cov = (jnp.einsum("nki,nkj->nij", d, d, precision=GEOMETRY_PRECISION)
               / wsum[..., None])
        return mean, cov, ok.any(-1)

    return fn


def mls_smooth(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float,
    prev_normals: jnp.ndarray,
    per_cell: int = 8,
    chunk: int = 4096,
    host_points: np.ndarray | None = None,
    host_valid: np.ndarray | None = None,
    backend: str = "auto",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (smoothed points, normals, valid).

    Points with no neighbors in radius are dropped (PCL MLS likewise
    produces no output sample for them).

    host_points/host_valid: optional host copies for sync-free grid
    geometry (see sor_filter).  backend "native" runs the C++ exact
    path on host and returns NUMPY arrays.
    """
    from reconstruction_tpu.cloud.backend import resolve_backend
    radius = float(radius)
    if resolve_backend(backend) == "native":
        from reconstruction_tpu import native
        pts_np = (np.asarray(points, np.float32) if host_points is None
                  else host_points)
        v_np = (valid if isinstance(valid, np.ndarray)
                else np.asarray(valid).astype(bool))
        return native.cloud_mls(pts_np, v_np, radius,
                                np.asarray(prev_normals, np.float32))
    origin, dims, cell = host_grid_geometry(
        np.asarray(points) if host_points is None else host_points,
        np.asarray(valid) if host_valid is None else host_valid, radius)
    grid = build_dense_grid(points, valid, origin, cell, dims,
                            pad=per_cell)
    mean, cov, any_ok = neighbor_map_dense(
        grid, points, valid, radius, _plane_stat(radius), dims,
        per_cell=per_cell, chunk=chunk)
    return _mls_epilogue(points, valid, mean, cov, any_ok, prev_normals)


@jax.jit
def _mls_epilogue(points, valid, mean, cov, any_ok, prev_normals):
    """Eigen + plane projection + re-orientation in ONE program."""
    _, n = smallest_eigenvector_3x3(cov)

    # Project each point onto its local plane.
    delta = points - mean
    dist = jnp.sum(delta * n, -1, keepdims=True)
    proj = points - dist * n

    # Re-orient vs pre-MLS normals (`CCloudOptimization.cpp:369-386`).
    flip = jnp.sum(n * prev_normals, -1) < 0
    n = jnp.where(flip[:, None], -n, n)

    ok = valid & any_ok
    return jnp.where(ok[:, None], proj, points), n, ok

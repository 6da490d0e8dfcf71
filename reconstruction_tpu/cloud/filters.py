"""Point-cloud outlier filters.

Statistical outlier removal replaces PCL's
`StatisticalOutlierRemoval(meanK=100, stddev=1)`
(`CCloudOptimization.cpp:82-86`): per-point mean distance to its k nearest
neighbors, then a global mu + thresh*sigma gate.  The kNN comes from the
voxel-grid candidate gather (capped) rather than an exact KD-tree — an
approximation that preserves the filter's statistics (validated against a
brute-force oracle in tests).

The optional radius-outlier-removal stage mirrors the reference's
commented-out `RadiusOutlierRemoval` (`CCloudOptimization.cpp:90-96`).

Both are host-entry wrappers around the DENSE voxel grid
(cloud/neighbors.py): grid dims are computed host-side and static, the
k-NN statistic reduces inside the candidate stream — O(M) memory and
contiguous slice loads (a materialized candidate set would cost ~19 GB
per 2.45M-point pair).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.cloud.neighbors import (
    build_dense_grid, host_grid_geometry, neighbor_map_dense)


def _mean_spacing(pts: np.ndarray, v: np.ndarray) -> float:
    """Estimated mean point spacing from the bounding box and count
    (surface-ish cloud: points scale with area, not volume).  Robust
    box (quantile + IQR fence), not min/max: triangulation outliers
    otherwise inflate the estimate by orders of magnitude."""
    if not v.any():
        return 1.0
    n_total = int(v.sum())  # spacing needs the TRUE count: dividing by
    # the subsample length would overestimate spacing sqrt(N/200k)-fold
    sel = pts[v]
    if len(sel) > 200_000:
        sel = sel[:: len(sel) // 200_000 + 1]
    from reconstruction_tpu.cloud.neighbors import robust_bbox
    lo, hi = robust_bbox(sel)
    ext = np.sort(np.maximum(hi - lo, 1e-6))
    area = float(ext[1] * ext[2])
    return float(np.sqrt(area / max(n_total, 1)))


@lru_cache(None)
def _knn_stat(k: int, bins: int = 32):
    def fn(q, cand, cpts, d2, ok):
        """Per-query mean-of-k-NN distance, reduced IN the candidate
        stream via a ``bins``-bucket distance histogram — INDEPENDENT
        masked reductions only, with no serial reduction chain (top_k or
        a loop-carried threshold bisection) over the (chunk,
        27*per_cell) block.

        Bin edges are per-query (relative to the max candidate
        distance), counts/sums accumulate per bin, and the k-NN mean is
        read off the cumulative histogram, taking the straddling bin at
        its average distance (bins are narrow; the mu+sigma gate only
        needs separation, validated vs the brute-force oracle in
        tests)."""
        dist = jnp.sqrt(jnp.where(ok, d2, 0.0))
        w = jnp.max(dist, axis=-1) + 1e-12                   # (c,)
        bi = jnp.clip((dist / w[..., None] * bins).astype(jnp.int32),
                      0, bins - 1)
        cnts, sums = [], []
        for b in range(bins):
            mb = ok & (bi == b)
            cnts.append(mb.sum(-1))
            sums.append(jnp.where(mb, dist, 0.0).sum(-1))
        cnt = jnp.stack(cnts, -1).astype(jnp.float32)        # (c, bins)
        sm = jnp.stack(sums, -1)
        ccum = jnp.cumsum(cnt, -1)
        total = ccum[..., -1]
        m = jnp.minimum(total, jnp.float32(k))               # effective k
        # take whole bins below the k-threshold, partial straddling bin
        # at its mean distance
        need = jnp.clip(m[..., None] - (ccum - cnt), 0.0, cnt)
        avg_bin = sm / jnp.maximum(cnt, 1.0)
        md = (need * avg_bin).sum(-1) / jnp.maximum(m, 1.0)
        # Density-consistent correction for truncated neighborhoods: for
        # a locally uniform surface sampling, mean-of-k-NN distance
        # scales as sqrt(k), so points that found only m < k candidates
        # get their statistic extrapolated by sqrt(k/m).  Without this
        # the per-point k varies and the global mu/sigma gate misfires.
        md = md * jnp.sqrt(jnp.float32(k) / jnp.maximum(m, 1.0))
        return md, total > 0

    return fn


def sor_filter(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    mean_k: int = 100,
    std_thresh: float = 1.0,
    per_cell: int = 32,
    chunk: int = 4096,
    host_points: np.ndarray | None = None,
    host_valid: np.ndarray | None = None,
    backend: str = "auto",
) -> jnp.ndarray:
    """Returns the updated validity mask (outliers dropped).

    host_points/host_valid: optional host copies of points/valid so the
    grid geometry costs no device->host sync (the orchestrator already
    holds the cloud on host; without these each cloud stage paid its own
    blocking transfer inside the per-pair loop).

    backend: "jax" (streaming device neighbor reduce), "native"
    (multi-threaded C++ exact k-NN, returns a NUMPY mask with zero device
    traffic) or "auto" (cloud/backend.py).
    """
    from reconstruction_tpu.cloud.backend import resolve_backend
    pts_np = (np.asarray(points, np.float32) if host_points is None
              else host_points)
    v_np = (np.asarray(valid).astype(bool) if host_valid is None
            else host_valid)
    spacing = _mean_spacing(pts_np, v_np)
    # Cell sized so 27 cells usually hold >= mean_k candidates.
    cell = spacing * float(np.sqrt(mean_k)) * 0.6 + 1e-6
    if resolve_backend(backend) == "native":
        from reconstruction_tpu import native
        mean_d, has = native.cloud_sor_stats(pts_np, v_np, float(cell),
                                             mean_k)
        return _sor_gate_np(mean_d, has, v_np, float(cell),
                            float(std_thresh))
    origin, dims, cell = host_grid_geometry(pts_np, v_np, cell)
    grid = build_dense_grid(points, valid, origin, cell, dims,
                            pad=per_cell)
    k = min(mean_k, 27 * per_cell)
    mean_d, has = neighbor_map_dense(
        grid, points, valid, cell, _knn_stat(k), dims,
        per_cell=per_cell, chunk=chunk, exclude_self=True)
    return _sor_gate(mean_d, has, valid, jnp.float32(cell),
                     jnp.float32(std_thresh))


def _sor_gate_np(mean_d, has, valid, cell, std_thresh):
    """Numpy twin of _sor_gate (same imputation + mu/sigma formula)."""
    has_nb = has & valid
    imputed = np.where(valid & ~has_nb, 10.0 * cell, mean_d)
    denom = max(int(valid.sum()), 1)
    mu = float(np.where(valid, imputed, 0.0).sum()) / denom
    sigma = float(np.sqrt(np.where(valid, (imputed - mu) ** 2, 0.0).sum()
                          / denom))
    return valid & has_nb & (mean_d <= mu + std_thresh * sigma)


@jax.jit
def _sor_gate(mean_d, has, valid, cell, std_thresh):
    """Global mu + thresh*sigma gate, fused into ONE program instead of
    ~10 separately dispatched scalar reduces."""
    has_nb = has & valid

    # PCL's exact kNN always finds k neighbors, so isolated points feed
    # their (large) distances into the global mu/sigma — which is what
    # makes the +sigma gate lenient on the inlier tail.  Radius-bounded
    # search loses that: impute a large statistic for zero-neighbor
    # points so the gate behaves the same, and kill them regardless.
    imputed = jnp.where(valid & ~has_nb, 10.0 * cell, mean_d)
    denom = jnp.maximum(valid.sum(), 1).astype(jnp.float32)
    mu = jnp.where(valid, imputed, 0.0).sum() / denom
    var = jnp.where(valid, (imputed - mu) ** 2, 0.0).sum() / denom
    sigma = jnp.sqrt(var)
    return valid & has_nb & (mean_d <= mu + std_thresh * sigma)


def _count_fn(q, cand, cpts, d2, ok):
    return ok.sum(-1)


def radius_outlier_filter(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float,
    min_neighbors: int = 50,
    per_cell: int = 16,
    chunk: int = 4096,
    host_points: np.ndarray | None = None,
    host_valid: np.ndarray | None = None,
) -> jnp.ndarray:
    """Drop points with fewer than min_neighbors within radius
    (`RadiusOutlierRemoval`, kept commented out in the reference at
    `CCloudOptimization.cpp:90-96`; enabled via
    cfg.cloud.use_radius_outlier_removal)."""
    pts_np = (np.asarray(points, np.float32) if host_points is None
              else host_points)
    v_np = (np.asarray(valid).astype(bool) if host_valid is None
            else host_valid)
    origin, dims, cell = host_grid_geometry(pts_np, v_np, radius)
    grid = build_dense_grid(points, valid, origin, cell, dims,
                            pad=per_cell)
    counts = neighbor_map_dense(
        grid, points, valid, radius, _count_fn, dims,
        per_cell=per_cell, chunk=chunk, exclude_self=True)
    return valid & (counts >= min_neighbors)


def radius_outlier_filter_np(
    points: np.ndarray,
    valid: np.ndarray,
    radius: float,
    min_neighbors: int = 50,
) -> np.ndarray:
    """Host (exact) twin of radius_outlier_filter for the native cloud
    backend: KD-tree neighbor counts, zero device traffic."""
    from scipy.spatial import cKDTree
    out = np.zeros(len(points), bool)
    sel = np.flatnonzero(valid)
    if len(sel) == 0:
        return out
    pts = np.asarray(points, np.float64)[sel]
    tree = cKDTree(pts)
    counts = tree.query_ball_point(pts, r=float(radius),
                                   return_length=True, workers=-1)
    out[sel] = (counts - 1) >= min_neighbors  # exclude self
    return out

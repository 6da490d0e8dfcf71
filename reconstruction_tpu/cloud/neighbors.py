"""Fixed-radius neighbor search on a voxel grid.

The reference leans on PCL KD-trees (`CCloudOptimization.cpp:103`,
`pcl::search::KdTree`) for SOR / normal estimation / MLS.  Pointer-chasing
trees don't map to a dense-compute machine; the array equivalent is a
sorted voxel grid with padded 27-cell candidate gathers (SURVEY.md
section 7 hard part (c)):

  1. quantize points to cells of size ``cell`` (>= search radius),
  2. argsort by flattened cell id,
  3. per query, binary-search the 27 adjacent cell ids and take up to
     ``per_cell`` consecutive entries from each — fixed-capacity, masked.

Everything is static-shape; queries stream through in chunks under
`lax.map` to bound the (chunk, 27*per_cell) candidate buffers.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class VoxelGrid(NamedTuple):
    points: jnp.ndarray      # (N, 3) original points
    valid: jnp.ndarray       # (N,) bool
    order: jnp.ndarray       # (N,) sort order (invalid last)
    sorted_ids: jnp.ndarray  # (N,) flattened cell id per sorted point
    origin: jnp.ndarray      # (3,) grid origin
    dims: jnp.ndarray        # (3,) int32 grid dims
    cell: jnp.ndarray        # scalar cell size


_INVALID_ID = np.int32(2 ** 30)  # plain numpy: no backend init at import


@jax.jit
def build_grid(points: jnp.ndarray, valid: jnp.ndarray, cell: jnp.ndarray) -> VoxelGrid:
    pts = points.astype(jnp.float32)
    big = jnp.float32(1e30)
    masked = jnp.where(valid[:, None], pts, big)
    origin = jnp.min(jnp.where(valid[:, None], pts, big), axis=0)
    origin = jnp.where(jnp.isfinite(origin) & (origin < 1e29), origin, 0.0)
    maxc = jnp.max(jnp.where(valid[:, None], pts, -big), axis=0)
    maxc = jnp.where(jnp.isfinite(maxc) & (maxc > -1e29), maxc, 0.0)
    dims = jnp.maximum(((maxc - origin) / cell).astype(jnp.int32) + 2, 1)
    ci = jnp.clip(((pts - origin) / cell).astype(jnp.int32), 0, dims - 1)
    ids = (ci[:, 0] * dims[1] + ci[:, 1]) * dims[2] + ci[:, 2]
    ids = jnp.where(valid, ids, _INVALID_ID)
    order = jnp.argsort(ids)
    return VoxelGrid(points=pts, valid=valid, order=order,
                     sorted_ids=ids[order], origin=origin, dims=dims,
                     cell=jnp.asarray(cell, jnp.float32))


class NeighborSet(NamedTuple):
    """Padded neighbor candidates for M query points."""

    idx: jnp.ndarray    # (M, K) indices into the ORIGINAL point array
    dist2: jnp.ndarray  # (M, K) squared distances (inf where invalid)
    ok: jnp.ndarray     # (M, K) bool


def neighbor_map(
    grid: VoxelGrid,
    queries: jnp.ndarray,
    q_valid: jnp.ndarray,
    radius: jnp.ndarray,
    fn,
    per_cell: int = 8,
    chunk: int = 4096,
    exclude_self: bool = False,
):
    """Stream queries through the padded 27-cell candidate gather and
    REDUCE each chunk with ``fn`` — candidates never materialize beyond
    one (chunk, 27*per_cell) block.

    This is the memory contract that makes million-point clouds work:
    returning raw candidates costs O(M * 27 * per_cell) device memory
    (19 GB at 2.5M points x per_cell 32);
    per-query statistics cost O(M).

    Args:
      fn: callback (q (c,3), cand (c,K) indices, cpts (c,K,3) positions,
        d2 (c,K), ok (c,K)) -> pytree of (c, ...) arrays.
    Returns fn's pytree stacked to (M, ...).
    """
    M = queries.shape[0]
    K = 27 * per_cell
    r2 = jnp.asarray(radius, jnp.float32) ** 2
    N = grid.points.shape[0]

    offs = jnp.stack(jnp.meshgrid(
        jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
        indexing="ij"), axis=-1).reshape(27, 3)

    nq = -(-M // chunk)
    Mp = nq * chunk
    qp = jnp.pad(queries.astype(jnp.float32), ((0, Mp - M), (0, 0)))
    vp = jnp.pad(q_valid, (0, Mp - M))
    qidx = jnp.pad(jnp.arange(M, dtype=jnp.int32), (0, Mp - M))

    def chunk_fn(args):
        q, qv, qi = args  # (chunk, 3), (chunk,), (chunk,)
        ci = jnp.clip(((q - grid.origin) / grid.cell).astype(jnp.int32),
                      0, grid.dims - 1)
        # 27 adjacent cell ids; out-of-grid neighbors are dropped (NOT
        # clamped — clamping would duplicate border cells and bias
        # k-nearest statistics with repeated candidates).
        nb = ci[:, None, :] + offs[None, :, :]
        in_grid = ((nb >= 0) & (nb < grid.dims)).all(-1)
        nbc = jnp.clip(nb, 0, grid.dims - 1)
        nb_ids = (nbc[..., 0] * grid.dims[1] + nbc[..., 1]) * grid.dims[2] + nbc[..., 2]
        nb_ids = jnp.where(in_grid, nb_ids, _INVALID_ID - 1)

        start = jnp.searchsorted(grid.sorted_ids, nb_ids)          # (chunk, 27)
        jj = jnp.arange(per_cell, dtype=jnp.int32)
        cand_sorted = start[..., None] + jj                          # (chunk, 27, per_cell)
        cand_sorted = jnp.clip(cand_sorted, 0, N - 1)
        cand_ids = grid.sorted_ids[cand_sorted]
        in_cell = cand_ids == nb_ids[..., None]
        cand = grid.order[cand_sorted].reshape(q.shape[0], K)
        in_cell = in_cell.reshape(q.shape[0], K)

        cpts = grid.points[cand]                                    # (chunk, K, 3)
        d2 = jnp.sum((cpts - q[:, None, :]) ** 2, axis=-1)
        ok = in_cell & (d2 <= r2) & qv[:, None]
        if exclude_self:
            ok = ok & (cand != qi[:, None])
        d2 = jnp.where(ok, d2, jnp.inf)
        return fn(q, cand, cpts, d2, ok)

    blocks = (qp.reshape(nq, chunk, 3), vp.reshape(nq, chunk),
              qidx.reshape(nq, chunk))
    out = jax.lax.map(chunk_fn, blocks)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(Mp, *a.shape[2:])[:M], out)


@partial(jax.jit, static_argnames=("per_cell", "chunk", "exclude_self"))
def gather_neighbors(
    grid: VoxelGrid,
    queries: jnp.ndarray,
    q_valid: jnp.ndarray,
    radius: jnp.ndarray,
    per_cell: int = 8,
    chunk: int = 4096,
    exclude_self: bool = False,
) -> NeighborSet:
    """Materialized candidates within ``radius`` of each query.

    O(M * 27 * per_cell) memory — fine for tests and small clouds; hot
    consumers (SOR / normals / MLS) reduce in-stream via `neighbor_map`.
    """
    out = neighbor_map(
        grid, queries, q_valid, radius,
        lambda q, cand, cpts, d2, ok: (cand, d2, ok),
        per_cell=per_cell, chunk=chunk, exclude_self=exclude_self)
    idx, d2, ok = out
    return NeighborSet(idx=idx, dist2=d2, ok=ok)


# ---------------------------------------------------------------------------
# Dense-bucket grid: the production path.
#
# The sorted-grid + searchsorted path above is fully jit-general (traced
# dims) but pays two costs at scale (2.45M points/pair): per-ELEMENT
# candidate gathers (grid.points[cand], ~6.4G scalar gathers across the
# pipeline) and searchsorted's ~21-step binary search (one scalar gather
# per query-cell per step).  With the cell DIMS static (computed host-side — every
# caller has the cloud on host anyway), both disappear:
#
#   * cell starts become one dense-table lookup: starts[cell_id],
#   * candidates become 27 CONTIGUOUS dynamic slices of the cell-sorted
#     point array (XLA gather with slice_sizes=(per_cell, 3) — vector
#     loads instead of scalar pointer chasing).
#
# Dims are rounded up (multiples of 32) so nearby shapes share compiles.
# ---------------------------------------------------------------------------


class DenseGrid(NamedTuple):
    sorted_pts: jnp.ndarray  # (N + per_cell_pad, 3) points in cell order
    order: jnp.ndarray       # (N + per_cell_pad,) original index per slot
    starts: jnp.ndarray      # (G + 3,) exclusive prefix of cell counts
    origin: jnp.ndarray      # (3,)
    cell: jnp.ndarray        # scalar


def robust_bbox(pts: np.ndarray, quantile: float = 5e-3):
    """Per-axis outlier-robust bounding box: the [q, 1-q] quantile box
    INTERSECTED with the Tukey fence [Q25 - 1.5 IQR, Q75 + 1.5 IQR].

    The quantile box alone breaks as soon as the outlier fraction
    exceeds q (0.5% spikes at +-60 units blow the cell
    size 500x past the point spacing); the IQR fence is immune up to
    25% contamination, while the quantile box keeps the fence from
    over-covering short-tailed distributions (for a uniform axis the
    1.5 IQR fence alone is 2x the true extent).  Points outside the box
    clamp into border cells; the d2 <= r^2 candidate check and their
    own garbage statistics handle them.  ``pts`` may be a subsample.
    """
    lo_q = np.quantile(pts, quantile, axis=0)
    hi_q = np.quantile(pts, 1.0 - quantile, axis=0)
    q25 = np.quantile(pts, 0.25, axis=0)
    q75 = np.quantile(pts, 0.75, axis=0)
    iqr = np.maximum(q75 - q25, 1e-6)
    lo = np.maximum(lo_q, q25 - 1.5 * iqr)
    hi = np.minimum(hi_q, q75 + 1.5 * iqr)
    return lo, hi


def host_grid_geometry(points, valid, cell, round_to=32,
                       max_cells=32_000_000, quantile=5e-3):
    """Host-side grid geometry: origin (np (3,)), STATIC dims tuple, and
    the cell size actually used (>= requested).

    Two robustness rules (the raw bbox of a pre-SOR stereo cloud is set
    by triangulation OUTLIERS — exactly the points the filter exists to
    remove — and would blow the dense cell table to billions of cells):

      * the bbox is the [q, 1-q] per-axis quantile box (outliers clamp
        into border cells; the d2 <= r^2 check rejects them as
        candidates, and their own garbage statistics get them killed),
      * the cell grows until the table fits ``max_cells`` — a bigger
        cell keeps the 27-cell neighborhood a SUPERSET of the search
        ball, so correctness is unchanged (per_cell capping just
        truncates more).

    Rounding dims up to ``round_to`` keeps recompiles rare across pairs
    of the same scene.
    """
    pts = np.asarray(points, np.float32)
    v = np.asarray(valid).astype(bool)
    cell = float(cell)
    if not v.any():
        return (np.zeros(3, np.float32), (round_to, round_to, round_to),
                max(cell, 1e-12))
    sel = pts[v]
    if len(sel) > 200_000:  # quantiles on a subsample: sort cost, same box
        sel = sel[:: len(sel) // 200_000 + 1]
    lo, hi = robust_bbox(sel, quantile)
    ext = np.maximum(hi - lo, 1e-6)
    cell = max(cell, 1e-12)
    while True:
        dims = np.maximum((ext / cell).astype(np.int64) + 2, 1)
        dims = ((dims + round_to - 1) // round_to) * round_to
        if int(dims[0] * dims[1] * dims[2]) <= max_cells:
            break
        cell *= 1.5
    origin = (lo - cell).astype(np.float32)  # one guard cell of margin
    return (origin, (int(dims[0]), int(dims[1]), int(dims[2])), cell)


@partial(jax.jit, static_argnames=("dims", "pad"))
def build_dense_grid(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    origin: jnp.ndarray,
    cell: jnp.ndarray,
    dims: Tuple[int, int, int],
    pad: int = 64,
) -> DenseGrid:
    G = dims[0] * dims[1] * dims[2]
    pts = points.astype(jnp.float32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    ci = jnp.clip(((pts - origin) / cell).astype(jnp.int32), 0, dims_arr - 1)
    ids = (ci[:, 0] * dims[1] + ci[:, 1]) * dims[2] + ci[:, 2]
    ids = jnp.where(valid, ids, G)  # bucket G collects invalid points
    order = jnp.argsort(ids)
    sorted_pts = pts[order]
    counts = jnp.zeros(G + 2, jnp.int32).at[ids].add(1)  # G+1 stays empty
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts, dtype=jnp.int32)])
    far = jnp.full((pad, 3), 1e30, jnp.float32)
    return DenseGrid(
        sorted_pts=jnp.concatenate([sorted_pts, far], axis=0),
        order=jnp.concatenate(
            [order.astype(jnp.int32), jnp.full(pad, -1, jnp.int32)]),
        starts=starts, origin=jnp.asarray(origin, jnp.float32),
        cell=jnp.asarray(cell, jnp.float32))


@partial(jax.jit, static_argnames=("dims", "fn", "per_cell", "chunk",
                                   "exclude_self"))
def _neighbor_map_dense_program(
    grid: DenseGrid,
    queries: jnp.ndarray,
    q_valid: jnp.ndarray,
    radius: jnp.ndarray,
    fn,
    dims: Tuple[int, int, int],
    per_cell: int = 8,
    chunk: int = 4096,
    exclude_self: bool = False,
    q_index0: jnp.ndarray | int = 0,
):
    """Dense-grid streaming neighbor reduce — same contract as
    `neighbor_map` (fn gets (q, cand, cpts, d2, ok) per chunk), with
    O(1) cell-start lookup and contiguous candidate slices.

    q_index0: GLOBAL index of queries[0] — candidate indices are global,
    so exclude_self must compare against global query ids when the
    caller splits the stream across programs (traced scalar: the
    split slices share one compile)."""
    M = queries.shape[0]
    G = dims[0] * dims[1] * dims[2]
    K = 27 * per_cell
    r2 = jnp.asarray(radius, jnp.float32) ** 2
    dims_arr = jnp.asarray(dims, jnp.int32)

    offs = jnp.asarray(np.stack(np.meshgrid(
        np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
        indexing="ij"), axis=-1).reshape(27, 3).astype(np.int32))

    nq = -(-M // chunk)
    Mp = nq * chunk
    qp = jnp.pad(queries.astype(jnp.float32), ((0, Mp - M), (0, 0)))
    vp = jnp.pad(q_valid, (0, Mp - M))
    qidx = (jnp.pad(jnp.arange(M, dtype=jnp.int32), (0, Mp - M))
            + jnp.asarray(q_index0, jnp.int32))
    jj = jnp.arange(per_cell, dtype=jnp.int32)

    def chunk_fn(args):
        q, qv, qi = args
        ci = jnp.clip(((q - grid.origin) / grid.cell).astype(jnp.int32),
                      0, dims_arr - 1)
        nb = ci[:, None, :] + offs[None, :, :]
        in_grid = ((nb >= 0) & (nb < dims_arr)).all(-1)
        nbc = jnp.clip(nb, 0, dims_arr - 1)
        nb_ids = (nbc[..., 0] * dims[1] + nbc[..., 1]) * dims[2] + nbc[..., 2]
        nb_ids = jnp.where(in_grid, nb_ids, G + 1)  # empty sentinel bucket

        s = grid.starts[nb_ids]                       # (chunk, 27) dense
        e = grid.starts[nb_ids + 1]
        cnt = jnp.minimum(e - s, per_cell)

        def sl(si):
            return (jax.lax.dynamic_slice(grid.sorted_pts, (si, 0),
                                          (per_cell, 3)),
                    jax.lax.dynamic_slice(grid.order, (si,), (per_cell,)))

        cpts, cord = jax.vmap(sl)(s.reshape(-1))
        cpts = cpts.reshape(q.shape[0], K, 3)
        cord = cord.reshape(q.shape[0], K)
        within = (jj[None, None, :] < cnt[..., None]).reshape(q.shape[0], K)

        d2 = jnp.sum((cpts - q[:, None, :]) ** 2, axis=-1)
        ok = within & (d2 <= r2) & qv[:, None]
        if exclude_self:
            ok = ok & (cord != qi[:, None])
        d2 = jnp.where(ok, d2, jnp.inf)
        return fn(q, cord, cpts, d2, ok)

    blocks = (qp.reshape(nq, chunk, 3), vp.reshape(nq, chunk),
              qidx.reshape(nq, chunk))
    out = jax.lax.map(chunk_fn, blocks)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(Mp, *a.shape[2:])[:M], out)


def _max_queries_per_program() -> int:
    """Queries per neighbor-map program (RECON_NEIGHBOR_MAX_QUERIES,
    default 400k): a larger query stream is split into equal slices of
    this size, which bounds each program's size and working memory.
    0 disables splitting."""
    import os
    return int(os.environ.get("RECON_NEIGHBOR_MAX_QUERIES", "400000"))


def neighbor_map_dense(
    grid: DenseGrid,
    queries: jnp.ndarray,
    q_valid: jnp.ndarray,
    radius: jnp.ndarray,
    fn,
    dims: Tuple[int, int, int],
    per_cell: int = 8,
    chunk: int = 4096,
    exclude_self: bool = False,
):
    """Entry point: splits the query stream into host-level slices of
    <= RECON_NEIGHBOR_MAX_QUERIES (default 400k; see
    `_max_queries_per_program`); results concatenate device-side.
    Equal-size slices (host padding) keep it to ONE compile."""
    M = queries.shape[0]
    max_q = _max_queries_per_program()
    if max_q <= 0 or M <= max_q:
        return _neighbor_map_dense_program(
            grid, queries, q_valid, radius, fn, dims,
            per_cell=per_cell, chunk=chunk, exclude_self=exclude_self)
    max_q = -(-max_q // chunk) * chunk           # align to the lax.map chunk
    ns = -(-M // max_q)
    Mp = ns * max_q
    qp = jnp.pad(queries.astype(jnp.float32), ((0, Mp - M), (0, 0)))
    vp = jnp.pad(q_valid, (0, Mp - M))
    outs = []
    for s in range(ns):
        lo, hi = s * max_q, (s + 1) * max_q
        outs.append(_neighbor_map_dense_program(
            grid, qp[lo:hi], vp[lo:hi], radius, fn, dims,
            per_cell=per_cell, chunk=chunk, exclude_self=exclude_self,
            q_index0=jnp.int32(lo)))
    cat = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    return jax.tree_util.tree_map(lambda a: a[:M], cat)

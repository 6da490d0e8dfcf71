"""Mesh post-processing: density trim, island removal, cleanup, smoothing,
hole closing.

Replaces `SurfaceTrimmer.x64.exe --smooth 100 --trim 7 --aRatio 0.01`
(`Demo/mesh.bat:2`) and the meshlab cleanup scripts
(`Demo/meshlab/script1.mlx` Laplacian smooth, `script2.mlx` isolated-piece
removal / duplicate / zero-area / non-manifold face removal + close holes
<= 30 edges).  Graph passes run host-side (scipy.sparse); smoothing is a
jit-able segment-sum relaxation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components


def vertex_density(density_grid: np.ndarray, verts_grid: np.ndarray) -> np.ndarray:
    """Trilinear sample of the splat-density grid at mesh vertices
    (vertices in GRID coordinates) — the stand-in for PoissonRecon's
    per-vertex density output consumed by SurfaceTrimmer."""
    R = np.asarray(density_grid.shape)
    p = np.clip(verts_grid, 0, R - 1 - 1e-6)
    i0 = np.floor(p).astype(np.int64)
    f = p - i0
    out = np.zeros(len(p))
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ii = np.minimum(i0 + [dx, dy, dz], R - 1)
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                out += w * density_grid[ii[:, 0], ii[:, 1], ii[:, 2]]
    return out


def density_trim(
    verts: np.ndarray,
    faces: np.ndarray,
    vdensity: np.ndarray,
    quantile: float = 0.05,
    smooth_iters: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop faces whose (smoothed) vertex density falls below a quantile
    (SurfaceTrimmer's value-trim, reformulated for the dense grid)."""
    d = vdensity.astype(np.float64).copy()
    if len(faces) == 0:
        return verts, faces
    adj = _vertex_adjacency(len(verts), faces)
    deg = np.maximum(np.asarray(adj.sum(axis=1)).ravel(), 1)
    for _ in range(smooth_iters):
        d = 0.5 * d + 0.5 * (adj @ d) / deg
    pos = d[d > 0]
    thr = np.quantile(pos, quantile) if len(pos) else 0.0
    keep_v = d >= thr
    keep_f = keep_v[faces].all(axis=1)
    return _compact(verts, faces[keep_f])


def _vertex_adjacency(nv: int, faces: np.ndarray) -> sp.csr_matrix:
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    data = np.ones(len(e))
    A = sp.coo_matrix((data, (e[:, 0], e[:, 1])), shape=(nv, nv)).tocsr()
    A.data[:] = 1.0
    return A


def _compact(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    used = np.zeros(len(verts), bool)
    used[faces.ravel()] = True
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(used.sum())
    return verts[used], remap[faces].astype(np.int32)


def remove_small_components(
    verts: np.ndarray,
    faces: np.ndarray,
    min_diag_frac: float = 0.10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove isolated pieces with bounding-box diagonal below
    min_diag_frac of the whole mesh diagonal (`script2.mlx`
    "Remove Isolated pieces (wrt Diameter)")."""
    if len(faces) == 0:
        return verts, faces
    A = _vertex_adjacency(len(verts), faces)
    n, labels = connected_components(A, directed=False)
    if n <= 1:
        return verts, faces
    diag_all = np.linalg.norm(verts.max(0) - verts.min(0))
    keep_labels = []
    for c in range(n):
        sel = labels == c
        if sel.sum() < 3:
            continue
        d = np.linalg.norm(verts[sel].max(0) - verts[sel].min(0))
        if d >= min_diag_frac * diag_all:
            keep_labels.append(c)
    keep_v = np.isin(labels, keep_labels)
    keep_f = keep_v[faces].all(axis=1)
    return _compact(verts, faces[keep_f])


def clean_mesh(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Duplicate-face / zero-area-face removal (`script2.mlx`,
    `script4color.mlx`)."""
    if len(faces) == 0:
        return verts, faces
    # duplicate faces (any vertex order); packed 1-D key when ids fit
    # 21 bits (np.unique axis=0 runs a structured sort)
    key = np.sort(faces, axis=1).astype(np.int64)
    if len(key) and int(key.max()) < (1 << 21):
        packed = (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
        _, first = np.unique(packed, return_index=True)
    else:
        _, first = np.unique(key, axis=0, return_index=True)
    faces = faces[np.sort(first)]
    # zero-area
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    area2 = np.linalg.norm(np.cross(a, b), axis=1)
    faces = faces[area2 > 1e-12]
    return _compact(verts, faces)


def boundary_loops(faces: np.ndarray) -> list:
    """Boundary edge loops (edges used by exactly one face)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    key = np.sort(e, axis=1).astype(np.int64)
    # packed 1-D key: np.unique(axis=0) runs a structured-void sort
    # (~5 s at 1.7M edges); the scalar path is ~10x faster
    packed = (key[:, 0] << 32) | key[:, 1]
    uniq, inv, cnt = np.unique(packed, return_inverse=True,
                               return_counts=True)
    bnd_mask = cnt[inv] == 1
    bnd = e[bnd_mask]  # directed boundary edges
    nxt = {int(a): int(b) for a, b in bnd}
    loops = []
    visited = set()
    for a in list(nxt):
        if a in visited:
            continue
        loop = [a]
        visited.add(a)
        cur = nxt.get(a)
        while cur is not None and cur != a and cur not in visited:
            loop.append(cur)
            visited.add(cur)
            cur = nxt.get(cur)
        if cur == a and len(loop) >= 3:
            loops.append(loop)
    return loops


def close_holes(
    verts: np.ndarray,
    faces: np.ndarray,
    max_edges: int = 30,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fan-fill boundary loops with at most max_edges edges
    (`script2.mlx` "Close Holes" MaxHoleSize=30)."""
    loops = [l for l in boundary_loops(faces) if len(l) <= max_edges]
    if not loops:
        return verts, faces
    new_faces = []
    for loop in loops:
        c = np.mean(verts[loop], axis=0)
        ci = len(verts) + len(new_faces) * 0  # placeholder; set below
        new_faces.append((loop, c))
    add_v = []
    add_f = []
    for loop, c in new_faces:
        ci = len(verts) + len(add_v)
        add_v.append(c)
        for i in range(len(loop)):
            a, b = loop[i], loop[(i + 1) % len(loop)]
            add_f.append([b, a, ci])  # reversed: fill opposes boundary dir
    verts2 = np.vstack([verts, np.asarray(add_v)])
    faces2 = np.vstack([faces, np.asarray(add_f, np.int32)])
    return verts2, faces2


def laplacian_smooth(
    verts: np.ndarray,
    faces: np.ndarray,
    iterations: int = 5,
    lam: float = 0.5,
    cotangent: bool = True,
    preserve_boundary: bool = True,
) -> np.ndarray:
    """Laplacian smoothing (`script1.mlx`: 5 steps, cotangent weighting,
    boundary handled separately)."""
    if len(faces) == 0:
        return verts
    v = verts.astype(np.float64).copy()
    nv = len(v)
    # boundary vertices (packed 1-D edge key, see boundary_loops)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    key = np.sort(e, axis=1).astype(np.int64)
    packed = (key[:, 0] << 32) | key[:, 1]
    uniq, inv, cnt = np.unique(packed, return_inverse=True,
                               return_counts=True)
    bnd_v = np.unique(e[cnt[inv] == 1])
    is_bnd = np.zeros(nv, bool)
    is_bnd[bnd_v] = True

    if cotangent:
        # Fused native path (C++ threads, native/src/cloud_stats.cpp):
        # the numpy formulation allocates ~30 temporaries of 60 MB per
        # iteration at production vertex counts.
        from reconstruction_tpu import native
        out = native.laplacian_cotan(v, faces, iterations, lam,
                                     is_bnd if preserve_boundary
                                     else np.zeros(nv, bool))
        if out is not None:
            return out

    # Precomputed edge index arrays: the sparsity never changes across
    # iterations, only the cotangent weights do, so the weighted average
    # is 4 bincounts per iteration instead of a sparse-matrix rebuild
    # (13.4 s -> ~3 s for 5 iterations at 615k verts).
    i, j, k = faces[:, 0], faces[:, 1], faces[:, 2]
    rows = np.concatenate([j, k, k, i, i, j])
    cols = np.concatenate([k, j, i, k, j, i])
    for _ in range(iterations):
        if cotangent:
            w = _cotan_edge_weights(v, faces)
        else:
            w = np.ones(len(rows))
        wv = w[:, None] * v[cols]
        acc = np.empty_like(v)
        for ax in range(3):
            acc[:, ax] = np.bincount(rows, weights=wv[:, ax], minlength=nv)
        deg = np.maximum(np.bincount(rows, weights=w, minlength=nv), 1e-12)
        avg = acc / deg[:, None]
        upd = v + lam * (avg - v)
        if preserve_boundary:
            upd[is_bnd] = v[is_bnd]
        v = upd
    return v


def _cotan_edge_weights(v: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-edge cotangent weights in the fixed (rows, cols) order used
    by laplacian_smooth: edge (j,k) gets cot at i, etc."""
    i, j, k = faces[:, 0], faces[:, 1], faces[:, 2]

    def cot(a, b, c):
        """cot of angle at a for triangle (a, b, c)."""
        u = v[b] - v[a]
        w = v[c] - v[a]
        cross = np.linalg.norm(np.cross(u, w), axis=1)
        dot = (u * w).sum(1)
        return dot / np.maximum(cross, 1e-12)

    w = np.concatenate([cot(i, j, k)] * 2 + [cot(j, k, i)] * 2
                       + [cot(k, i, j)] * 2)
    return np.clip(w, 0.0, 1e3)  # clamp negatives (obtuse) for stability

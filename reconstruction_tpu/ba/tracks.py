"""Feature matching + multi-view track building.

Descriptor matching is one NCC matmul per view pair with
mutual-best + threshold gating; tracks link matches transitively via
host-side union-find (tiny data), then get padded to the (M, O)
observation layout `BAProblem` expects.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.ba.bundle_adjust import BAProblem
from reconstruction_tpu.ba.features import Features


@jax.jit
def match_descriptors(dA: jnp.ndarray, okA: jnp.ndarray,
                      dB: jnp.ndarray, okB: jnp.ndarray,
                      threshold: float = 0.8) -> jnp.ndarray:
    """Mutual-best NCC matches.  Returns (N,) index into B or -1."""
    S = dA @ dB.T
    S = jnp.where(okA[:, None] & okB[None, :], S, -2.0)
    best_ab = jnp.argmax(S, axis=1)
    best_ba = jnp.argmax(S, axis=0)
    score = jnp.take_along_axis(S, best_ab[:, None], axis=1)[:, 0]
    mutual = best_ba[best_ab] == jnp.arange(S.shape[0])
    good = mutual & (score >= threshold)
    return jnp.where(good, best_ab, -1)


class _UF:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def build_tracks(
    feats: Sequence[Features],
    descs: Sequence[jnp.ndarray],
    K: Sequence[np.ndarray],
    Rt: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    threshold: float = 0.8,
    min_views: int = 2,
    max_obs: int = 8,
) -> BAProblem:
    """Match the given view pairs and link into tracks.

    Track points are initialized by two-view midpoint triangulation of the
    first two observations.
    """
    nviews = len(feats)
    counts = [int(np.asarray(f.ok).sum()) for f in feats]
    offsets = np.cumsum([0] + [f.xy.shape[0] for f in feats])
    total = offsets[-1]
    uf = _UF(total)
    for (a, b) in pairs:
        m = np.asarray(match_descriptors(descs[a], feats[a].ok,
                                         descs[b], feats[b].ok, threshold))
        for i, j in enumerate(m):
            if j >= 0:
                uf.union(offsets[a] + i, offsets[b] + int(j))

    groups = {}
    for v in range(nviews):
        okv = np.asarray(feats[v].ok)
        xyv = np.asarray(feats[v].xy)
        for i in range(feats[v].xy.shape[0]):
            if not okv[i]:
                continue
            root = uf.find(offsets[v] + i)
            groups.setdefault(root, []).append((v, xyv[i]))

    tracks = [g for g in groups.values()
              if len({v for v, _ in g}) >= min_views
              and len(g) == len({v for v, _ in g})]  # one obs per view
    M = len(tracks)
    O = max_obs
    obs_uv = np.zeros((M, O, 2), np.float32)
    obs_cam = np.zeros((M, O), np.int32)
    obs_ok = np.zeros((M, O), bool)
    pts0 = np.zeros((M, 3), np.float32)
    for mi, g in enumerate(tracks):
        for oi, (v, xy) in enumerate(g[:O]):
            obs_uv[mi, oi] = xy
            obs_cam[mi, oi] = v
            obs_ok[mi, oi] = True
        (va, xa), (vb, xb) = g[0], g[1]
        pts0[mi] = _triangulate_midpoint(K[va], Rt[va], xa, K[vb], Rt[vb], xb)

    return BAProblem(
        K=jnp.asarray(np.stack(K), jnp.float32),
        Rt0=jnp.asarray(np.stack(Rt), jnp.float32),
        points0=jnp.asarray(pts0),
        obs_uv=jnp.asarray(obs_uv),
        obs_cam=jnp.asarray(obs_cam),
        obs_ok=jnp.asarray(obs_ok),
    )


def _triangulate_midpoint(Ka, Rta, xa, Kb, Rtb, xb) -> np.ndarray:
    """Midpoint of the two back-projected rays."""
    def ray(K, Rt, x):
        R, t = np.asarray(Rt)[:, :3], np.asarray(Rt)[:, 3]
        C = -R.T @ t
        d = R.T @ np.linalg.inv(K) @ np.array([x[0], x[1], 1.0])
        return C, d / np.linalg.norm(d)
    Ca, da = ray(Ka, Rta, xa)
    Cb, db = ray(Kb, Rtb, xb)
    # closest points on the two rays
    w0 = Ca - Cb
    a = da @ da
    b = da @ db
    c = db @ db
    d = da @ w0
    e = db @ w0
    den = a * c - b * b
    if abs(den) < 1e-12:
        return (Ca + Cb) / 2
    s = (b * e - c * d) / den
    t = (a * e - b * d) / den
    return ((Ca + s * da) + (Cb + t * db)) / 2

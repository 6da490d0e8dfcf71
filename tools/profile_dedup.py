"""Dedup at bench shape: cross_view_dedup on a 4-pair,
~3.3M-point fused cloud with working-resolution (1920x1280) bucket
grids — the only default-off production path that had never run at
bench scale.  CPU by default; pass --gpu for the on-card number.

Prints kept-point counts per rule and wall time.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--gpu" not in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np
import jax.numpy as jnp


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tests"))
    from synthetic import surface_fn
    from reconstruction_tpu.cloud.dedup import DedupInputs, cross_view_dedup

    P, H, W = 4, 1920, 1280
    per_pair = 830_000
    n = P * per_pair
    rng = np.random.default_rng(0)

    # Overlapping surface patches: every pair sees a shifted window of
    # the same surface, so ~half the points are cross-pair duplicates.
    xyz_parts, nrm_parts = [], []
    for p in range(P):
        cx = -0.9 + 0.6 * p   # 60% overlap between consecutive pairs
        xy = np.column_stack([
            rng.uniform(cx - 0.9, cx + 0.9, per_pair),
            rng.uniform(-1.2, 1.2, per_pair)]).astype(np.float32)
        z = surface_fn(xy[:, 0], xy[:, 1]).astype(np.float32)
        xyz_parts.append(np.column_stack([xy, z]))
        eps = 1e-3
        gx = (surface_fn(xy[:, 0] + eps, xy[:, 1])
              - surface_fn(xy[:, 0] - eps, xy[:, 1])) / (2 * eps)
        gy = (surface_fn(xy[:, 0], xy[:, 1] + eps)
              - surface_fn(xy[:, 0], xy[:, 1] - eps)) / (2 * eps)
        nv = np.column_stack([-gx, -gy, np.ones(per_pair)]).astype(np.float32)
        nv /= np.linalg.norm(nv, axis=1, keepdims=True)
        nrm_parts.append(nv)
    xyz = np.concatenate(xyz_parts)
    nrm = np.concatenate(nrm_parts)

    # Camera contexts: ring of 4 cam0 centers above the surface, simple
    # pinhole P matrices at working resolution.
    P0s, P1s, centers = [], [], []
    for p in range(P):
        cx = -0.9 + 0.6 * p
        C = np.array([cx, 0.0, 6.0])
        K = np.array([[1500.0, 0, W / 2], [0, 1500.0, H / 2], [0, 0, 1.0]])
        R = np.diag([1.0, 1.0, -1.0])  # look down -z ... points below cam
        R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
        t = -R @ C
        P0s.append((K @ np.hstack([R, t[:, None]])).astype(np.float32))
        C1 = C + np.array([0.15, 0, 0])
        t1 = -R @ C1
        P1s.append((K @ np.hstack([R, t1[:, None]])).astype(np.float32))
        centers.append(C.astype(np.float32))
    masks = np.full((P, H, W), 1.0, np.float32)
    ctx = DedupInputs(P0=jnp.asarray(np.stack(P0s)),
                      P1=jnp.asarray(np.stack(P1s)),
                      centers=jnp.asarray(np.stack(centers)),
                      masks0=jnp.asarray(masks))

    pts = jnp.asarray(xyz)
    nr = jnp.asarray(nrm)
    val = jnp.ones(n, bool)

    t0 = time.perf_counter()
    keep = cross_view_dedup(pts, nr, val, ctx)
    keep_h = np.asarray(keep)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    keep_h = np.asarray(cross_view_dedup(pts, nr, val, ctx))
    warm = time.perf_counter() - t0
    kept = int(keep_h.sum())
    print(f"[dedup] n={n} kept={kept} ({100.0 * kept / n:.1f}%)  "
          f"cold={cold:.2f}s warm={warm:.2f}s  "
          f"platform={jax.devices()[0].platform}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

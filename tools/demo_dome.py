"""BASELINE configs[3] at scale on the virtual mesh: a synthetic
32-camera dome, 16 pairs, >=2K working resolution, through the
PRODUCTION sharded entry point (`reconstruct(mesh=...)`) on the 8-way
CPU pair axis.

What this demonstrates:
  * memory feasibility — 16 pairs x 5-level 2K pyramids live as 2
    pairs/device-lane batches; peak RSS is recorded,
  * correctness at dome scale — the fused mesh's point-to-surface RMSE
    against the analytic scene,
  * the pair-axis padding/repeat machinery at its intended multiplicity
    (16 real pairs on an 8-way axis: 2 per lane, no padding; run with
    --pairs 12 for ragged padding).

The refine iteration budget is reduced (--refine, default 6+6/level)
for CPU-host tractability: the budget scales COMPUTE only; memory
shape, sharding layout and stage structure are identical to the full
budget.  On a real pod the same invocation runs the full budget.

    python tools/demo_dome.py [--pairs 16] [--width 1920] [--json out]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    import os
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    import dataclasses
    from synthetic import make_stereo_scene, point_to_surface_rmse
    from reconstruction_tpu.config import preset
    from reconstruction_tpu.parallel.mesh import make_mesh
    from reconstruction_tpu.pipeline.reconstruct import (PairInput,
                                                         reconstruct)

    ncam = 2 * args.pairs
    # dome32 preset geometry scaled to the requested working width
    # (preset: 5 levels from 240x135 -> 3840x2160; 1920 -> base 120x68).
    base_w = args.width >> (args.levels - 1)
    base_h = max(2 * round(base_w * 9 / 32), 2)
    cfg = preset("dome32").replace(
        pyramid_levels=args.levels,
        lowest_level_size=(base_w, base_h),
        cam_pairs=tuple((2 * i, 2 * i + 1) for i in range(args.pairs)))
    cfg = cfg.replace(
        stereo=dataclasses.replace(cfg.stereo, refine_iters_base=args.refine,
                                   refine_iters_per_level=args.refine),
        cloud=dataclasses.replace(cfg.cloud, mls_radius=0.08, sor_mean_k=30),
        surface=dataclasses.replace(cfg.surface, grid_resolution=128,
                                    mg_cycles=4))

    Wf, Hf = cfg.finest_size
    print(f"[dome] {ncam} cameras, {args.pairs} pairs, finest {Wf}x{Hf}, "
          f"{args.levels} levels, refine {args.refine}+{args.refine}/level",
          flush=True)

    t0 = time.perf_counter()
    cams, imgs, masks = make_stereo_scene(
        image_size=(Wf, Hf), span_deg=200.0, num_cameras=ncam)
    print(f"[dome] scene render {time.perf_counter() - t0:.1f}s", flush=True)

    pairs = [PairInput(
        image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
        K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
        K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
        for (a, b) in cfg.cam_pairs]

    mesh = make_mesh(jax.devices()[:args.devices], frame=1,
                     pair=args.devices, tile=1)
    t0 = time.perf_counter()
    r = reconstruct(cfg, pairs, mesh=mesh)
    wall = time.perf_counter() - t0
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    rmse = point_to_surface_rmse(r.vertices)

    out = {"cameras": ncam, "pairs": args.pairs, "finest": [Wf, Hf],
           "levels": args.levels, "devices": args.devices,
           "wall_s": round(wall, 1), "peak_rss_mb": round(rss_mb),
           "verts": int(len(r.vertices)), "faces": int(len(r.faces)),
           "cloud_points": int(len(r.cloud_xyz)),
           "surface_rmse": round(float(rmse), 5),
           "stages_s": {k: round(v, 2) for k, v in r.timer.spans.items()
                        if "/" not in k or k.endswith("_sharded")}}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    assert np.isfinite(r.vertices).all() and len(r.vertices) > 10000
    assert rmse < 0.2, rmse


if __name__ == "__main__":
    main()

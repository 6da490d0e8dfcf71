"""Headline benchmark: views FUSED per second per chip, end to end.

Workload = the reference's "myself" rig shape (`BatchProcess/main.cpp:
30-35,59-61`): 4 camera pairs {0,1},{2,3},{4,5},{7,6}, PyrmNum=4, base
160x240 -> finest 1280x1920 — run through the ENTIRE pipeline the
reference times as "total time" (`reconstruction/main.cpp:22`): per pair
rectify -> pyramid match (full per-level recipe incl. 30+30*level
refinement sweeps) -> triangulate -> SOR -> normals; then global MLS ->
Poisson(grid 256^3) -> marching -> trim/cleanup/smooth -> texture.  One
"view fused" = one camera image carried from pixels to the final
textured mesh (a pair fuses 2 views; both directions are matched like
the reference).

The scene is a synthetic calibrated 8-camera rig around an analytic
height-field surface (tests/synthetic.py), rendered once at the finest
working resolution and cached under .bench_cache/ — geometry is known
exactly, so the bench also reports point-to-surface RMSE as a fidelity
cross-check.

The reference publishes no numbers (BASELINE.md); `vs_baseline` compares
against an operation-count model of its CPU MATCHING stage alone
(0.017 views/s) — conservative toward the reference, since our numerator
additionally pays for its PCL/meshing minutes.

Prints ONE JSON line:
  {"metric": "views_fused_per_sec_per_chip", "value": N, "unit": "views/s",
   "vs_baseline": R, "device": {...}, "matching_s": ..., "total_s": ...,
   "stages_s": {...}, "mesh": {...}, "kernels": {per-kernel measured
   roofline: gflops_per_s / hbm_gbps / utilization / bound}}

All phases run inline in ONE process that holds the card; the JSON line
names the card (`jax.devices()[0].device_kind`) and its power limit.  A
run without a GPU fails (utils/profiling.require_gpu): no number from
another device is ever printed under a device metric.

Env knobs:
  RECON_BENCH_MODE=full|stereo   stereo = matching-only loop (A/B tool)
  RECON_BENCH_PAIRS=N            limit pair count (default 4)
  RECON_BENCH_REPS=N             timed repetitions after the cold run
                                 (default 2; stereo mode 3)
  RECON_BENCH_BASE=WxH, RECON_BENCH_LEVELS=N, RECON_BENCH_GRID=N
                                 shrink the configuration (smoke runs)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REFERENCE_VIEWS_PER_SEC = 0.017  # op-count model, see the docstring
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------

def build_rig(image_size, num_cameras=8, span_deg=42.0, tag="myself"):
    """Calibrated rig + rendered views at the working resolution, cached
    under .bench_cache/ (row bands of the views render in one worker
    process per host core)."""
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(
        CACHE, f"rig_{tag}_{image_size[0]}x{image_size[1]}_{num_cameras}.npz")
    if os.path.exists(path):
        z = np.load(path)
        n = int(z["n"])
        return ([{"K": z[f"K{i}"], "Rt": z[f"Rt{i}"]} for i in range(n)],
                [z[f"img{i}"] for i in range(n)],
                [z[f"mask{i}"] for i in range(n)])
    from synthetic import make_stereo_scene
    print(f"[bench] rendering {num_cameras} views at {image_size} "
          f"(cached after first run)...", file=sys.stderr, flush=True)
    cams, imgs, masks = make_stereo_scene(
        image_size=image_size, span_deg=span_deg, num_cameras=num_cameras,
        processes=os.cpu_count() or 1)
    out = {"n": num_cameras}
    for i, (c, img, msk) in enumerate(zip(cams, imgs, masks)):
        out[f"K{i}"] = np.asarray(c.K, np.float64)
        out[f"Rt{i}"] = np.asarray(c.Rt, np.float64)
        out[f"img{i}"] = np.clip(img, 0, 255).astype(np.uint8)
        out[f"mask{i}"] = (msk > 127).astype(np.uint8) * np.uint8(255)
    np.savez_compressed(path, **out)
    z = np.load(path)
    return ([{"K": z[f"K{i}"], "Rt": z[f"Rt{i}"]} for i in range(num_cameras)],
            [z[f"img{i}"] for i in range(num_cameras)],
            [z[f"mask{i}"] for i in range(num_cameras)])


def bench_config(npairs):
    """The myself preset with cloud radii scaled to the synthetic scene's
    world units (the reference's 2.5 suits its mm-scale captures; the
    scene surface spans ~3.2 units at ~0.002 point spacing)."""
    import dataclasses
    from reconstruction_tpu.config import preset
    cfg = preset("myself")
    kw = {}
    if "RECON_BENCH_BASE" in os.environ:  # smoke-test scaling, e.g. "40x60"
        w, h = os.environ["RECON_BENCH_BASE"].split("x")
        kw["lowest_level_size"] = (int(w), int(h))
    if "RECON_BENCH_LEVELS" in os.environ:
        kw["pyramid_levels"] = int(os.environ["RECON_BENCH_LEVELS"])
    surface = cfg.surface
    if "RECON_BENCH_GRID" in os.environ:
        surface = dataclasses.replace(
            surface, grid_resolution=int(os.environ["RECON_BENCH_GRID"]))
    return cfg.replace(
        cam_pairs=cfg.cam_pairs[:npairs],
        cloud=dataclasses.replace(cfg.cloud, mls_radius=0.02),
        surface=surface,
        **kw)


def make_pairs(cfg, cams, imgs, masks):
    from reconstruction_tpu.pipeline.reconstruct import PairInput
    pairs = []
    for (a, b) in cfg.cam_pairs:
        pairs.append(PairInput(
            image0=imgs[a].astype(np.float32),
            image1=imgs[b].astype(np.float32),
            mask0=masks[a].astype(np.float32),
            mask1=masks[b].astype(np.float32),
            K0=cams[a]["K"], Rt0=cams[a]["Rt"],
            K1=cams[b]["K"], Rt1=cams[b]["Rt"]))
    return pairs


# ---------------------------------------------------------------------------
# measured kernel rooflines (BASELINE.md: NCC cost volume, refine, BA Schur)
# ---------------------------------------------------------------------------

def time_call(fn, *args, reps=5):
    """Median seconds per call of a jitted ``fn`` after one compile+warm
    call, each call fenced by `jax.block_until_ready`."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_inputs(H=1920, W=1280, nsh=64, seed=7):
    """The kernel phase's finest-level inputs: a synthetic pair, its
    margins, and per-pixel sweep bounds spanning exactly ``nsh`` shifts
    (disparity 0..nsh-1 — bounds are ABSOLUTE target columns, so they
    track x)."""
    import jax.numpy as jnp
    from reconstruction_tpu.config import NOMATCH
    from reconstruction_tpu.stereo.margins import find_margin
    imgL, imgR, mask = synth_pair(H, W, np.random.default_rng(seed))
    valid = mask > 127
    xg = jnp.arange(W, dtype=jnp.int32)[None, :]
    lo = jnp.broadcast_to(xg, (H, W))
    hi = jnp.minimum(lo + nsh - 1, W - 1)
    disp0 = jnp.asarray(np.where(valid, 40.0, NOMATCH).astype(np.float32))
    return dict(imgL=jnp.asarray(imgL), imgR=jnp.asarray(imgR),
                valid=jnp.asarray(valid), lo=lo, hi=hi, disp0=disp0,
                margins=find_margin(jnp.asarray(valid), 2))


def sweep_and_refine(k):
    """Jitted XLA NCC sweep (64 shifts, radius 2) and 30-sweep refine on
    kernel_inputs ``k``; returns {name: (fn, args)}."""
    import jax
    from reconstruction_tpu.stereo.matching import ncc_sweep_match
    from reconstruction_tpu.stereo.refine import disparity_refine
    m = k["margins"]
    sweep = jax.jit(lambda a, b, v, lo, hi: ncc_sweep_match(
        a, b, v, v, lo, hi, 2).disparity)
    refine = jax.jit(lambda d, a, b: disparity_refine(
        d, a, b, m, iterations=30, ws=0.03))
    return {"ncc_sweep": (sweep, (k["imgL"], k["imgR"], k["valid"],
                                  k["lo"], k["hi"])),
            "refine": (refine, (k["disp0"], k["imgL"], k["imgR"]))}


def measure_kernels(kind):
    """On-card seconds for the three hot kernels, fed through the
    analytic FLOP/byte model (utils/profiling.py) -> measured roofline."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from reconstruction_tpu.ba.bundle_adjust import BAProblem, ba_step
    from reconstruction_tpu.utils.profiling import (
        ncc_sweep_cost, refine_cost, schur_cost)

    H, W, nsh = 1920, 1280, 64
    fns = sweep_and_refine(kernel_inputs(H, W, nsh))
    costs = {"ncc_sweep": ncc_sweep_cost(H, W, 3, 2, nsh),
             "refine": refine_cost(H, W, 30, build_shifts=40)}
    out = {}
    for name, (fn, args) in fns.items():
        t = time_call(fn, *args)
        out[name] = dict(seconds=t, **costs[name].utilization(t, kind))

    # BA Schur step: 16 cams, 64k points, 8 obs/point.
    rng = np.random.default_rng(7)
    C, M, O = 16, 1 << 16, 8
    K = np.tile(np.array([[1000.0, 0, 640], [0, 1000, 960], [0, 0, 1]],
                         np.float32), (C, 1, 1))
    Rt0 = np.tile(np.hstack([np.eye(3), [[0], [0], [8.0]]]).astype(np.float32),
                  (C, 1, 1))
    prob = BAProblem(
        K=jnp.asarray(K), Rt0=jnp.asarray(Rt0),
        points0=jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32)),
        obs_uv=jnp.asarray(rng.uniform(0, 1000, (M, O, 2)).astype(np.float32)),
        obs_cam=jnp.asarray(rng.integers(0, C, (M, O)).astype(np.int32)),
        obs_ok=jnp.asarray(np.ones((M, O), bool)))
    step = jax.jit(ba_step, static_argnames=("num_cameras",))
    t = time_call(partial(step, num_cameras=C), prob,
                  jnp.zeros((C, 6), jnp.float32), prob.points0)
    out["ba_schur"] = dict(seconds=t,
                           **schur_cost(M, O, C).utilization(t, kind))
    return out


def synth_pair(H, W, rng):
    """Synthetic rectified pair with a smooth disparity field (stereo-mode
    workload and kernel-roofline inputs)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tex = rng.uniform(0, 255, (H, W + 256, 3)).astype(np.float32)
    for ax in (0, 1):
        for _ in range(2):
            tex = 0.5 * tex + 0.25 * (np.roll(tex, 1, ax) + np.roll(tex, -1, ax))
    disp = 40.0 + 25.0 * np.sin(2 * np.pi * xx / W) * np.cos(2 * np.pi * yy / H)
    imgL = tex[:, :W]
    xs = (xx + disp).astype(np.int32) % (W + 256)
    imgR = tex[yy, xs]
    mask = np.zeros((H, W), np.float32)
    mask[8:-8, 8:-8] = 255.0
    return imgL, imgR, mask


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def aggregate_stages(spans):
    """Collapse pairN/* spans; keep global stage names."""
    agg = {}
    for k, v in spans.items():
        key = k.split("/", 1)[1] if k.startswith("pair") else k
        agg[key] = agg.get(key, 0.0) + v
    return {k: round(v, 3) for k, v in agg.items()}


def run_full(npairs, reps):
    from reconstruction_tpu.pipeline.reconstruct import reconstruct
    from synthetic import point_to_surface_rmse

    cfg = bench_config(npairs)
    W, H = cfg.finest_size
    cams, imgs, masks = build_rig((W, H))
    pairs = make_pairs(cfg, cams, imgs, masks)

    runs = []
    import gc
    for r in range(reps + 1):  # run 0 = cold (compile); rest timed
        t0 = time.perf_counter()
        c0 = time.process_time()
        rec = reconstruct(cfg, pairs)
        total = time.perf_counter() - t0
        cpu = time.process_time() - c0
        rmse = point_to_surface_rmse(rec.vertices)
        mesh = {"verts": int(len(rec.vertices)),
                "faces": int(len(rec.faces)),
                "cloud_points": int(len(rec.cloud_xyz)),
                "surface_rmse": float(rmse)}
        host = {"cpu_over_wall": cpu / max(total, 1e-9),
                "host_cores": os.cpu_count()}
        spans = dict(rec.timer.spans)
        runs.append((total, spans, mesh, host))
        print(f"[bench] {'cold' if r == 0 else f'run {r}'}: "
              f"{total:.1f}s  stages={aggregate_stages(spans)}",
              file=sys.stderr, flush=True)
        del rec  # do not hold result graphs across timed runs
        gc.collect()
    timed = runs[1:] or runs[:1]  # reps == 0: report the cold run
    total, spans, mesh, host = min(timed, key=lambda run: run[0])
    # "Matching time" (`reconstruction/main.cpp:18`) = dispatch + the
    # fetch spans (the fetch of pair i overlaps pair i+1's device work,
    # so their SUM bounds the stereo wall from above).
    matching_s = sum(v for k, v in spans.items()
                     if k.endswith("/stereo") or k.endswith("/fetch"))
    out = {"matching_s": matching_s,
           "total_s": total,
           "cold_total_s": runs[0][0],
           "stages_s": aggregate_stages(spans),
           "mesh": mesh,
           "host": host,
           "all_runs_s": [t for t, *_ in runs],
           "views_per_s": 2.0 * npairs / total}
    if reps == 0:  # mark so a consumer never mistakes cold for a regression
        out["warming"] = True
    return out


def run_stereo_only(reps):
    """Matching-only loop (one pair's level programs) for A/B work."""
    import jax
    import jax.numpy as jnp
    from reconstruction_tpu.core.pyramid import build_pyramid, quantize_u8
    from reconstruction_tpu.stereo.pipeline import match_one_level

    cfg = bench_config(1)  # honors RECON_BENCH_BASE/LEVELS smoke knobs
    W, H = cfg.finest_size
    rng = np.random.default_rng(0)
    imgL, imgR, mask = synth_pair(H, W, rng)
    pyrL = build_pyramid(jnp.asarray(imgL), cfg.pyramid_levels)
    pyrR = build_pyramid(jnp.asarray(imgR), cfg.pyramid_levels)
    pyrM = [quantize_u8(m) for m in build_pyramid(jnp.asarray(mask),
                                                  cfg.pyramid_levels)]

    def one_level(state, level):
        return match_one_level(
            quantize_u8(pyrL[level]), quantize_u8(pyrR[level]),
            pyrM[level], pyrM[level], state, level,
            radius=cfg.stereo.block_radius,
            offset=cfg.stereo.disparity_offset,
            ws=cfg.stereo.refine_ws,
            refine_iters=cfg.refine_iterations(level),
            median_iters=cfg.stereo.median_iterations,
            recenter_every=cfg.stereo.refine_recenter_every)

    state = None
    cold = []
    for level in range(cfg.pyramid_levels):
        t0 = time.perf_counter()
        state = jax.block_until_ready(one_level(state, level))
        cold.append(time.perf_counter() - t0)
        print(f"[bench] level {level} compile+run: {cold[-1]:.2f}s",
              file=sys.stderr, flush=True)

    per_pair = sum(cold)  # reps == 0 (warming session): the cold pass
    for r in range(reps):
        state = None
        t0 = time.perf_counter()
        for level in range(cfg.pyramid_levels):
            state = one_level(state, level)
        jax.block_until_ready(state)
        per_pair = min(per_pair, time.perf_counter() - t0)
    print(f"[bench] stereo: {per_pair:.3f}s/pair", file=sys.stderr,
          flush=True)
    out = {"matching_s": per_pair, "total_s": per_pair,
           "stages_s": {"stereo": per_pair},
           "mesh": {}, "views_per_s": 2.0 / per_pair}
    if reps == 0:
        out["warming"] = True
    return out


def merge(results, device):
    """The single JSON record: the full-pipeline phase when present (the
    stereo-only protocol otherwise), the stereo-only figures beside it,
    the kernel rooflines, and the device it all ran on."""
    full = results.get("full", {})
    stereo = results.get("stereo", {})
    base = full or stereo
    vps = base.get("views_per_s", 0.0)
    out = {
        "metric": "views_fused_per_sec_per_chip",
        "value": vps,
        "unit": "views/s",
        "vs_baseline": vps / REFERENCE_VIEWS_PER_SEC,
        "device": device,
    }
    for k in ("matching_s", "total_s", "cold_total_s", "stages_s", "mesh",
              "host", "all_runs_s", "warming"):
        if k in base:
            out[k] = base[k]
    if stereo and full:
        out["stereo_only"] = {k: stereo[k] for k in
                              ("matching_s", "views_per_s") if k in stereo}
    out["kernels"] = results.get("kernels", {})
    return out


def main():
    from reconstruction_tpu.utils.compile_cache import enable_compile_cache
    from reconstruction_tpu.utils.profiling import (
        device_peaks, gpu_name_and_power_limit, require_gpu)

    dev = require_gpu()
    enable_compile_cache()
    kind, _ = device_peaks(dev)
    device = {"platform": dev.platform, "kind": kind,
              "count": len(__import__("jax").devices()),
              "nvidia_smi": gpu_name_and_power_limit()}
    print(f"[bench] device: {device}", file=sys.stderr, flush=True)

    mode = os.environ.get("RECON_BENCH_MODE", "full")
    npairs = int(os.environ.get("RECON_BENCH_PAIRS", "4"))
    results = {"kernels": measure_kernels(kind)}
    results["stereo"] = run_stereo_only(
        int(os.environ.get("RECON_BENCH_REPS", "3")))
    if mode == "full":
        results["full"] = run_full(
            npairs, int(os.environ.get("RECON_BENCH_REPS", "2")))
    print(json.dumps(merge(results, device)))


if __name__ == "__main__":
    main()

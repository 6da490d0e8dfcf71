"""Card-side smoke check of the main path: `python chip_smoke.py [--four]`.

Runs `reconstruct()` (what `python -m reconstruction_tpu config.yml`
calls) on one NVIDIA GPU at the repo's real deployment — the "myself"
face rig, 4 pairs, 1280x1920 finest level, 4 pyramid levels, 30+30*level
refine sweeps, 256^3 Poisson grid (`bench.bench_config(4)`) — and checks
it, in ONE process that holds the card:

  1. device gate: JAX's first device must be a GPU; prints the device
     and `nvidia-smi`'s name and power limit; the native host library
     must build and load;
  2. stage agreement at real width: one rig pair, level by level, the
     production level program on the GPU against its two halves on the
     CPU backend of the same process, with the same inputs (integer
     disparities, validity, refined disparity, triangulation, and the
     Poisson chi of the fused cloud), against TOLERANCES;
  3. the full pipeline, cold then warm: non-empty mesh, surface RMSE
     against the analytic scene <= RMSE_MAX, wall times, stage spans,
     peak device memory;
  4. the CLI on a small scene written in the reference's on-disk format.

`--four` runs only the pair-sharded path (`reconstruct(mesh=...)`, CLI
`--sharded`) over a pair=4 mesh of four GPUs and the sequential
`reconstruct` on GPU 0 it is compared with, pair by pair (the equality
contract of tests/test_parallel.py::test_production_sharded_*).

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed; any failure exits non-zero.  The
timings printed are smoke timings from one run, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.join(REPO, "tests"), REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# Stated tolerances of the GPU-vs-CPU stage agreement (phase 2).
TOLERANCES = {
    # integer disparities after the constraints, before refine: equal on
    # this share of pixels valid in both (f32 NCC argmax near-ties may
    # flip under another summation order)
    "int_equal_frac": 0.999,
    # validity (NOMATCH pattern) agreement, before and after refine
    "valid_agree_frac": 0.999,
    # refined disparity from the same integer input: p99 |delta| in px.
    # The finest level (the output) is held to this; a coarser level to
    # the larger of this and NOISE_FACTOR x its own noise floor (below).
    "refine_p99_abs": 0.05,
    # triangulated xyz from the same disparity: max |delta| / scene extent
    "xyz_max_rel": 1e-4,
    # Poisson chi of the same fused cloud: relative L2 (cuFFT vs the CPU
    # FFT, and scatter-add atomics in run-varying order)
    "chi_rel_l2": 1e-4,
}
# The refine's noise floor, measured in every run: the CPU refine from
# the same integer disparities with one input image scaled by
# (1 + NOISE_REL), against the unperturbed CPU refine.  The parabola fit
# switches branches on near-degenerate costs, so this ulp-level input
# change alone moves the coarse, smoother levels by tenths of a pixel.
# The GPU differs from the CPU in the rounding of every operation, not
# of one input, hence the factor.
NOISE_REL = 2e-7
NOISE_FACTOR = 3.0
# Surface RMSE bound against tests/synthetic.surface_fn (phase 3).
RMSE_MAX = 0.009


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device gate
# ---------------------------------------------------------------------------

def device_gate():
    """The first GPU; raises on any other platform (never falls back)."""
    import jax
    from reconstruction_tpu.utils.profiling import require_gpu
    dev = require_gpu()
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    return dev


def native_gate() -> int:
    """The native host library (marching, mesh cleanup, PLY packing)
    must build and load; returns its worker thread count."""
    from reconstruction_tpu import native
    n = native.threads()
    log(f"native library: {'loaded' if n else 'NOT loaded'}, "
        f"{n} worker threads (std::thread)")
    if not n:
        raise RuntimeError("the native host library did not build or load")
    return n


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


# ---------------------------------------------------------------------------
# 2. stage agreement
# ---------------------------------------------------------------------------

def _both_valid(a, b):
    from reconstruction_tpu.config import NOMATCH
    return (a != NOMATCH) & (b != NOMATCH)


def refine_p99(ref_a, ref_b) -> float:
    """p99 |delta| of two refined disparities over pixels valid in
    both, the worse of the two directions."""
    p99 = []
    for ra, rb in zip(ref_a, ref_b):
        ra, rb = np.asarray(ra), np.asarray(rb)
        both = _both_valid(ra, rb)
        p99.append(float(np.percentile(np.abs(ra[both] - rb[both]), 99))
                   if both.any() else 0.0)
    return max(p99)


def compare_level(int_a, int_b, ref_a, ref_b) -> dict:
    """Agreement of one level's integer (pre-refine) and refined
    disparities, both directions; a is the device under test."""
    from reconstruction_tpu.config import NOMATCH
    eq, agree = [], []
    for ia, ib in zip(int_a, int_b):
        ia, ib = np.asarray(ia), np.asarray(ib)
        both = _both_valid(ia, ib)
        eq.append(float((ia[both] == ib[both]).mean()) if both.any() else 1.0)
        agree.append(float(((ia != NOMATCH) == (ib != NOMATCH)).mean()))
    for ra, rb in zip(ref_a, ref_b):
        ra, rb = np.asarray(ra), np.asarray(rb)
        agree.append(float(((ra != NOMATCH) == (rb != NOMATCH)).mean()))
    return {"int_equal_frac": min(eq), "valid_agree_frac": min(agree),
            "refine_p99_abs": refine_p99(ref_a, ref_b)}


def refine_limit(noise_p99: float, finest: bool) -> float:
    """The refine bound of one level: TOLERANCES at the finest level;
    at a coarser one, also no tighter than NOISE_FACTOR x the level's
    measured noise floor."""
    lim = TOLERANCES["refine_p99_abs"]
    return lim if finest else max(lim, NOISE_FACTOR * noise_p99)


def compare_cloud(cloud_a, cloud_b) -> dict:
    """Triangulation agreement from the same disparity."""
    va, vb = np.asarray(cloud_a.valid), np.asarray(cloud_b.valid)
    xa, xb = np.asarray(cloud_a.xyz), np.asarray(cloud_b.xyz)
    both = va & vb
    extent = float(np.ptp(xa[both], axis=0).max()) if both.any() else 1.0
    err = float(np.abs(xa[both] - xb[both]).max()) if both.any() else 0.0
    return {"valid_agree_frac": float((va == vb).mean()),
            "xyz_max_abs": err, "scene_extent": extent,
            "xyz_max_rel": err / max(extent, 1e-12)}


def compare_chi(chi_a, chi_b) -> dict:
    a = np.asarray(chi_a, np.float64)
    b = np.asarray(chi_b, np.float64)
    return {"chi_rel_l2": float(np.linalg.norm(a - b)
                                / max(np.linalg.norm(b), 1e-30))}


def check(metrics: dict, limits: dict | None = None) -> list:
    """Failures of ``metrics`` against TOLERANCES, overridden by
    ``limits`` (fractions are lower bounds, errors upper bounds)."""
    limits = {**TOLERANCES, **(limits or {})}
    bad = []
    for k, v in metrics.items():
        if k not in limits:
            continue
        lim = limits[k]
        ok = v >= lim if k.endswith("_frac") else v <= lim
        if not (ok and np.isfinite(v)):
            bad.append(f"{k}={v!r} (limit {lim})")
    return bad


def _on(dev, tree):
    import jax
    return jax.device_put(tree, dev)


def level_halves():
    """match_one_level's two halves as programs of their own, for the
    reference side: the integer half, and the subpixel half from given
    integer disparities."""
    import jax
    from reconstruction_tpu.stereo.pipeline import (
        both_directions, level_integer, level_refine)

    def integer_half(img0, img1, mask0, mask1, coarse, level, radius,
                     offset):
        lanes, m0, m1 = both_directions(img0, img1, mask0, mask1, radius)
        return level_integer(lanes, m0, m1, coarse, level, radius, offset)

    def refine_half(img0, img1, mask0, mask1, d0, d1, radius, ws,
                    refine_iters, median_iters, s_cap, recenter_every):
        lanes, m0, m1 = both_directions(img0, img1, mask0, mask1, radius)
        return level_refine(lanes, m0, m1, d0, d1, ws, refine_iters,
                            median_iters, s_cap, recenter_every)

    return (jax.jit(integer_half,
                    static_argnames=("level", "radius", "offset")),
            jax.jit(refine_half,
                    static_argnames=("radius", "ws", "refine_iters",
                                     "median_iters", "s_cap",
                                     "recenter_every")))


def stage_agreement(cfg, pin, dev_a, dev_b, report=log) -> dict:
    """One pair through the production stereo path on ``dev_a``
    (match_pair_dispatch / match_pair_finish), then level by level the
    production level program (match_one_level) on ``dev_a`` against its
    two halves on ``dev_b``: the integer half from the same coarse state,
    the refine from dev_a's own integer disparities (pre_refine0/1), and
    the same refine from one input image scaled by (1 + NOISE_REL), the
    level's noise floor.  Then the finest triangulation from the same
    disparity.  Returns {stage: metrics}; raises if any stage is outside
    its limits."""
    import jax
    from reconstruction_tpu.core.pyramid import build_pyramid, quantize_u8
    from reconstruction_tpu.stereo.pipeline import (
        LevelState, match_one_level, match_pair_dispatch, match_pair_finish)
    from reconstruction_tpu.stereo.triangulate import disparity_to_cloud

    with jax.default_device(dev_a):
        work = match_pair_dispatch(
            cfg, pin.image0, pin.image1, pin.mask0, pin.mask1,
            pin.K0, pin.Rt0, pin.K1, pin.Rt1)
        res = match_pair_finish(work)
        L = cfg.pyramid_levels
        pyr0 = build_pyramid(work.imgs[0], L)
        pyr1 = build_pyramid(work.imgs[1], L)
        mp0 = [quantize_u8(m) for m in build_pyramid(work.masks[0], L)]
        mp1 = [quantize_u8(m) for m in build_pyramid(work.masks[1], L)]
        levels = [(quantize_u8(pyr0[i]), quantize_u8(pyr1[i]), mp0[i],
                   mp1[i]) for i in range(L)]

    st = cfg.stereo
    integer_half, refine_half = level_halves()
    out, failures = {}, []
    state = None
    for level in range(L):
        kw = dict(radius=st.block_radius, ws=st.refine_ws,
                  refine_iters=cfg.refine_iterations(level),
                  median_iters=st.median_iterations, s_cap=128,
                  recenter_every=st.refine_recenter_every)
        coarse = (None if state is None
                  else LevelState(disp0=state.disp0, disp1=state.disp1))
        state = match_one_level(*_on(dev_a, levels[level]),
                                _on(dev_a, coarse), level,
                                offset=st.disparity_offset, **kw)
        xb = _on(dev_b, levels[level])
        ints_a = (state.pre_refine0, state.pre_refine1)
        ints_b = integer_half(*xb, _on(dev_b, coarse), level,
                              radius=st.block_radius,
                              offset=st.disparity_offset)
        ref_b = refine_half(*xb, *_on(dev_b, ints_a), **kw)
        noisy = (xb[0] * np.float32(1 + NOISE_REL),) + tuple(xb[1:])
        ref_n = refine_half(*noisy, *_on(dev_b, ints_a), **kw)
        m = compare_level(ints_a, ints_b, state[:2], ref_b[:2])
        m["refine_noise_p99"] = refine_p99(ref_b[:2], ref_n[:2])
        m["refine_p99_limit"] = refine_limit(m["refine_noise_p99"],
                                             finest=level == L - 1)
        # whether the level-by-level chain reproduced production's
        # finest result bit for bit (reported; scatter-adds may reorder)
        if level == L - 1:
            m["production_equal"] = bool(np.array_equal(
                np.asarray(state.disp0), np.asarray(work.state.disp0)))
        out[f"level{level}"] = m
        report(f"  level {level} {levels[level][0].shape[:2]}: {m}")
        failures += [f"level{level}: {b}" for b in check(
            m, {"refine_p99_abs": m["refine_p99_limit"]})]

    finest = L - 1
    rect = work.rect
    args = (work.state.disp0, work.mpyr0_finest,
            quantize_u8(work.pyr0_finest), rect.Q, rect.R_final,
            rect.T_final, work.m0)
    cloud_b = disparity_to_cloud(*_on(dev_b, args), work.scale,
                                 erode_frac=st.cloud_erode_frac)
    m = compare_cloud(res.cloud, cloud_b)
    m["precision"] = "HIGHEST"
    out["triangulate"] = m
    report(f"  triangulate (level {finest}, precision HIGHEST): {m}")
    failures += [f"triangulate: {b}" for b in check(m)]
    if failures:
        raise AssertionError("stage agreement outside tolerance: "
                             + "; ".join(failures))
    return out


def poisson_agreement(cfg, xyz, nrm, dev_a, dev_b, report=log) -> dict:
    """Poisson chi of one fused cloud on both devices."""
    from reconstruction_tpu.surface.poisson import poisson_reconstruct
    chis = []
    for dev in (dev_a, dev_b):
        p, n, v = _on(dev, (np.asarray(xyz, np.float32),
                            np.asarray(nrm, np.float32),
                            np.ones(len(xyz), bool)))
        chis.append(poisson_reconstruct(
            p, n, v, resolution=cfg.surface.grid_resolution,
            cycles=cfg.surface.mg_cycles,
            point_weight=cfg.surface.point_weight).chi)
    m = compare_chi(*chis)
    report(f"  poisson chi ({len(xyz)} points, "
           f"{cfg.surface.grid_resolution}^3): {m}")
    bad = check(m)
    if bad:
        raise AssertionError("poisson agreement outside tolerance: "
                             + "; ".join(bad))
    return m


# ---------------------------------------------------------------------------
# 3. full pipeline, 4. CLI
# ---------------------------------------------------------------------------

def bench_rig(npairs=4):
    import bench
    cfg = bench.bench_config(npairs)
    t0 = time.perf_counter()
    cams, imgs, masks = bench.build_rig(cfg.finest_size)
    log(f"rig: {len(imgs)} views at {cfg.finest_size} "
        f"({time.perf_counter() - t0:.1f}s to render or load)")
    return cfg, bench.make_pairs(cfg, cams, imgs, masks)


def full_pipeline(cfg, pairs, dev, card):
    import bench
    from reconstruction_tpu.pipeline.reconstruct import reconstruct
    from synthetic import point_to_surface_rmse
    rec = None
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        rec = reconstruct(cfg, pairs)
        wall = time.perf_counter() - t0
        rmse = point_to_surface_rmse(rec.vertices)
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"  {run}: wall {wall:.3f} s, surface RMSE {rmse:.6f}, "
            f"cloud {len(rec.cloud_xyz)} points, {len(rec.vertices)} "
            f"vertices, peak device memory {peak} B  [{card}]")
        log(f"  {run} stage spans (s): "
            f"{json.dumps(bench.aggregate_stages(rec.timer.spans))}")
        if len(rec.vertices) == 0 or len(rec.faces) == 0:
            raise AssertionError(f"{run}: empty mesh")
        if not rmse <= RMSE_MAX:
            raise AssertionError(f"{run}: surface RMSE {rmse} > {RMSE_MAX}")
    return rec


def write_cli_scene(workdir: str) -> str:
    """A 2-camera 320x240 scene in the reference's on-disk format
    (OpenCV-YAML config + calibration, PNG images and masks,
    `CManageData.cpp:26-66`); returns the config path."""
    from synthetic import make_stereo_scene
    from reconstruction_tpu.io.images import imwrite
    from reconstruction_tpu.io.opencv_yaml import save_opencv_yaml
    cams, imgs, masks = make_stereo_scene(image_size=(320, 240),
                                          num_cameras=2)
    calib, imagelist, masklist = {}, [], []
    for i, (c, img, msk) in enumerate(zip(cams, imgs, masks)):
        calib[f"intrinsic-{i}"] = np.asarray(c.K, np.float64)
        calib[f"extrinsic-{i}"] = np.asarray(c.Rt, np.float64)
        imwrite(os.path.join(workdir, f"img{i}.png"), img)
        imwrite(os.path.join(workdir, f"mask{i}.png"), msk)
        imagelist.append(f"img{i}.png")
        masklist.append(f"mask{i}.png")
    save_opencv_yaml(os.path.join(workdir, "calib_camera.yml"), calib)
    config = os.path.join(workdir, "config.yml")
    save_opencv_yaml(config, {
        "filepath": workdir,
        "outfilename": os.path.join(workdir, "out.ply"),
        "isoutput": 0,
        "camera_calib_name": "calib_camera.yml",
        "PyrmNum": 3,
        "LowestLevelWidth": 80,
        "LowestLevelHeight": 60,
        "imagelist": imagelist,
        "masklist": masklist,
        "camID": np.array([[0, 1]], np.int32),  # OpenCV mats have no int64
    })
    return config


def cli_check(workdir: str, max_rmse: float = 0.25) -> dict:
    """Run the CLI in-process on a written scene and check its PLY."""
    from reconstruction_tpu.__main__ import main as cli_main
    from reconstruction_tpu.io.ply import read_ply
    from synthetic import point_to_surface_rmse
    config = write_cli_scene(workdir)
    rc = cli_main(["reconstruction_tpu", config])
    if rc not in (0, None):
        raise AssertionError(f"CLI returned {rc}")
    ply = read_ply(os.path.join(workdir, "out.ply"))
    rmse = point_to_surface_rmse(ply.xyz)
    m = {"verts": int(len(ply.xyz)),
         "faces": int(len(ply.faces)) if ply.faces is not None else 0,
         "interior_rmse": float(rmse)}
    if not (m["verts"] > 1000 and m["faces"] > 0 and rmse < max_rmse):
        raise AssertionError(f"CLI output PLY fails its check: {m}")
    return m


# ---------------------------------------------------------------------------
# --four: pair-sharded path vs sequential
# ---------------------------------------------------------------------------

# The sharded-equals-sequential contract of test_production_sharded_*:
# disparities equal up to f32 reassociation (vmapped level programs
# reassociate box sums; refine's parabola division amplifies ~1e-5
# diffs on isolated pixels), taken over every pixel (NOMATCH in both
# counts as equal, so a validity flip is a difference far past "max"),
# and equal cloud validity, margins and rectified images.
SHARDED_LIMITS = {"median": 1e-4, "p90": 0.01, "max": 1.0,
                  "frac_gt_0.25": 0.01}


def compare_sharded(d_seq, d_sh, valid_seq, valid_sh) -> dict:
    """Sharded vs sequential disparity and cloud validity of one pair."""
    diff = np.abs(np.asarray(d_seq) - np.asarray(d_sh))
    return {"median": float(np.median(diff)),
            "p90": float(np.percentile(diff, 90)),
            "max": float(diff.max()),
            "frac_gt_0.25": float((diff > 0.25).mean()),
            "cloud_valid_equal": bool(np.array_equal(valid_seq, valid_sh))}


def check_sharded(m: dict) -> list:
    bad = [f"{k}={m[k]!r} (limit {v})" for k, v in SHARDED_LIMITS.items()
           if not m[k] < v]
    return bad + [k for k in ("cloud_valid_equal", "margins_equal",
                              "rect_image_equal") if k in m and not m[k]]


def sharded_vs_sequential(cfg, pairs, devices, card):
    """The production entry point with a pair=N mesh (one pair per
    card) against the sequential path on card 0, pair by pair under
    test_production_sharded_*'s contract, then the meshes."""
    import jax
    from reconstruction_tpu.parallel.mesh import make_mesh
    from reconstruction_tpu.pipeline.reconstruct import reconstruct
    from synthetic import point_to_surface_rmse

    mesh = make_mesh(devices, frame=1, pair=len(devices), tile=1)
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        r_seq = reconstruct(cfg, pairs)
        log(f"  sequential reconstruct (card 0): "
            f"{time.perf_counter() - t0:.3f} s  [{card}]")
    t0 = time.perf_counter()
    r_sh = reconstruct(cfg, pairs, mesh=mesh)
    log(f"  sharded reconstruct (pair={len(devices)} mesh): "
        f"{time.perf_counter() - t0:.3f} s, cold  [{card}]")
    failures = []
    if "stereo_sharded" not in r_sh.timer.spans:
        failures.append("reconstruct(mesh=...) did not run pair-sharded")
    for i, (a, b) in enumerate(zip(r_seq.pair_results, r_sh.pair_results)):
        m = compare_sharded(a.disparity, b.disparity,
                            np.asarray(a.cloud.valid),
                            np.asarray(b.cloud.valid))
        m["margins_equal"] = (b.margins0 == a.margins0
                              and b.margins1 == a.margins1)
        m["rect_image_equal"] = bool(np.array_equal(
            np.asarray(b.rect_images[0]), np.asarray(a.rect_images[0])))
        log(f"  pair {i} sharded vs sequential: {m}")
        bad = check_sharded(m)
        if bad:
            failures.append(f"pair {i}: {bad}")
    for name, r in (("sequential", r_seq), ("sharded", r_sh)):
        rmse = point_to_surface_rmse(r.vertices)
        log(f"  {name}: surface RMSE {rmse:.6f}, {len(r.cloud_xyz)} cloud "
            f"points, {len(r.vertices)} vertices")
        if not rmse <= RMSE_MAX:
            failures.append(f"{name} RMSE {rmse} > {RMSE_MAX}")
    nv_seq, nv_sh = len(r_seq.vertices), len(r_sh.vertices)
    if not abs(nv_sh - nv_seq) < 0.02 * nv_seq:
        failures.append(f"vertex counts differ >2%: {nv_sh} vs {nv_seq}")
    for d in devices:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"  peak device memory {d}: {peak} B  [{card}]")
    if failures:
        raise AssertionError("sharded != sequential: " + "; ".join(failures))


# ---------------------------------------------------------------------------

def run_phase(name, fn, failed):
    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        fn()
    except Exception:  # reported and turned into the exit code below
        traceback.print_exc()
        failed.append(name)
        log(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        return
    log(f"== {name}: ok in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the pair-sharded path on four GPUs vs the "
                         "sequential path on GPU 0")
    args = ap.parse_args(argv)

    import jax
    from reconstruction_tpu.utils.compile_cache import enable_compile_cache
    from reconstruction_tpu.utils.profiling import gpu_name_and_power_limit

    dev = device_gate()
    card = gpu_name_and_power_limit()
    log(card)
    log(f"compile cache: {enable_compile_cache()}")
    cpu = jax.devices("cpu")[0]
    failed = []
    state = {}
    run_phase("native library", native_gate, failed)

    def rig():
        state["cfg"], state["pairs"] = bench_rig()

    run_phase("rig", rig, failed)
    if "rig" in failed:
        log(f"FAILED phases: {failed}")
        return 1
    cfg, pairs = state["cfg"], state["pairs"]
    if args.four:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            log(f"--four needs 4 GPUs, found {len(jax.devices())}")
            return 1
        run_phase("sharded vs sequential (pair=4 mesh)",
                  lambda: sharded_vs_sequential(cfg, pairs, devices, card),
                  failed)
    else:
        run_phase("stage agreement (GPU vs CPU, pair 0)",
                  lambda: stage_agreement(cfg, pairs[0], dev, cpu), failed)

        def full():
            state["rec"] = full_pipeline(cfg, pairs, dev, card)

        run_phase("full pipeline (reconstruct, bench_config(4))", full,
                  failed)
        if "rec" in state:
            rec = state["rec"]
            run_phase("poisson agreement (GPU vs CPU, fused cloud)",
                      lambda: poisson_agreement(
                          cfg, rec.cloud_xyz, rec.cloud_normals, dev, cpu),
                      failed)
        else:
            failed.append("poisson agreement (no fused cloud)")

        def cli():
            with tempfile.TemporaryDirectory() as wd:
                log(f"  {cli_check(wd)}")

        run_phase("CLI (python -m reconstruction_tpu config.yml)", cli,
                  failed)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(card)
    print(result_line(dev.platform, dev.device_kind,
                      4 if args.four else len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

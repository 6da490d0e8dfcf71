"""Property tests: vectorized stereo stages vs the sequential oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.stereo.margins import Margins, find_margin
from reconstruction_tpu.stereo.matching import (
    brute_force_match, guided_search_bounds, ncc_sweep_match, rematch)
from reconstruction_tpu.stereo.constraints import (
    median_filter, ordering_constraint, propagate_bounds,
    smoothness_constraint, uniqueness_constraint)
from reconstruction_tpu.stereo.refine import disparity_refine


def _random_scene(rng, H=36, W=48, hole_p=0.25):
    """Random textured pair + blobby masks + structured disparity map."""
    imgL = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    imgR = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    def blobmask():
        m = np.zeros((H, W), bool)
        m[4:-4, 4:-4] = True
        holes = rng.uniform(size=(H, W)) < 0.05
        return m & ~holes
    vL, vR = blobmask(), blobmask()
    disp = rng.integers(-3, 4, size=(H, W)).astype(np.float64)
    disp[rng.uniform(size=(H, W)) < hole_p] = NOMATCH
    disp[~vL] = NOMATCH
    return imgL, imgR, vL, vR, disp


def _margins(valid, radius=2):
    m = oracle.find_margin(valid, radius)
    return m, Margins(*[jnp.int32(v) for v in m])


def test_find_margin_matches_oracle(rng):
    for _ in range(5):
        v = rng.uniform(size=(30, 40)) < 0.2
        mo = oracle.find_margin(v, 2)
        mj = find_margin(jnp.asarray(v), 2)
        assert mo == (int(mj.YL), int(mj.YR), int(mj.XL), int(mj.XR))


def test_brute_match_matches_oracle(rng):
    imgL, imgR, vL, vR, _ = _random_scene(rng, H=24, W=32)
    mo_L, mj_L = _margins(vL)
    mo_R, mj_R = _margins(vR)
    ours = np.asarray(brute_force_match(
        jnp.asarray(imgL), jnp.asarray(imgR), jnp.asarray(vL),
        jnp.asarray(vR), mj_L, mj_R, 2))
    ref = oracle.brute_match(imgL.astype(np.float64), imgR.astype(np.float64),
                             vL, vR, mo_L, mo_R, 2)
    # identical argmax except possible f32-vs-f64 near-ties
    mismatch = (ours != ref).sum()
    assert mismatch <= 0.01 * (ref != NOMATCH).sum() + 2, mismatch


def test_sweep_with_per_pixel_bounds(rng):
    """ncc_sweep_match with arbitrary per-pixel bounds == direct argmax."""
    imgL, imgR, vL, vR, _ = _random_scene(rng, H=20, W=28)
    H, W = vL.shape
    mo_L, mj_L = _margins(vL)
    lo = rng.integers(0, W // 2, size=(H, W))
    hi = lo + rng.integers(0, 6, size=(H, W))
    active = vL.copy()
    res = ncc_sweep_match(jnp.asarray(imgL), jnp.asarray(imgR),
                          jnp.asarray(vR), jnp.asarray(active),
                          jnp.asarray(lo, np.int32), jnp.asarray(hi, np.int32), 2)
    ours = np.asarray(res.disparity)
    bad = 0
    for y in range(H):
        for x in range(W):
            if not active[y, x]:
                assert ours[y, x] == NOMATCH
                continue
            best, bt = -1.0, -1
            for t in range(lo[y, x], min(hi[y, x], W - 1) + 1):
                if t < 0 or not vR[y, t]:
                    continue
                v = oracle.ncc(imgL.astype(np.float64),
                               imgR.astype(np.float64), y, x, t, 2)
                if v > best:
                    best, bt = v, t
            want = (bt - x) if bt != -1 else NOMATCH
            if ours[y, x] != want:
                bad += 1
    assert bad <= 3, bad


def test_guided_bounds_match_oracle(rng):
    H, W = 32, 44
    Hc, Wc = H // 2, W // 2
    coarse = rng.integers(-3, 4, size=(Hc, Wc)).astype(np.float64)
    coarse[rng.uniform(size=(Hc, Wc)) < 0.4] = NOMATCH
    vL = np.zeros((H, W), bool)
    vL[3:-3, 3:-3] = True
    vR = vL.copy()
    mo_L, mj_L = _margins(vL)
    mo_R, mj_R = _margins(vR)
    lo, hi = guided_search_bounds(jnp.asarray(coarse), mj_L, mj_R, H, W, 2)
    lo_o, hi_o = oracle.guided_bounds(coarse, vL, mo_L, mo_R, 2, H, W)
    YL, YR, XL, XR = mo_L
    box = np.zeros((H, W), bool)
    box[YL:YR + 1, XL:XR + 1] = True
    np.testing.assert_array_equal(np.asarray(lo)[box], lo_o[box])
    np.testing.assert_array_equal(np.asarray(hi)[box], hi_o[box])


def test_smoothness_matches_oracle(rng):
    _, _, vL, _, disp = _random_scene(rng)
    mo, mj = _margins(vL)
    ours = np.asarray(smoothness_constraint(jnp.asarray(disp, jnp.float32), mj))
    ref = oracle.smoothness(disp, mo)
    np.testing.assert_array_equal(ours, ref)


def test_ordering_matches_oracle(rng):
    for _ in range(3):
        _, _, vL, _, disp = _random_scene(rng, H=20, W=30)
        mo, mj = _margins(vL)
        ours = np.asarray(ordering_constraint(jnp.asarray(disp, jnp.float32), mj))
        ref = oracle.ordering(disp, mo)
        np.testing.assert_array_equal(ours, ref)


def test_uniqueness_matches_oracle(rng):
    _, _, vL, vR, d0 = _random_scene(rng)
    d1 = _random_scene(rng)[4]
    mo0, mj0 = _margins(vL)
    mo1, mj1 = _margins(vR)
    o0, o1 = uniqueness_constraint(
        jnp.asarray(d0, jnp.float32), jnp.asarray(d1, jnp.float32), mj0, mj1)
    r0 = oracle.uniqueness_pass(d0, d1, mo0, mo1)
    r1 = oracle.uniqueness_pass(d1, r0, mo1, mo0)
    r0 = oracle.uniqueness_pass(r0, r1, mo0, mo1)
    np.testing.assert_array_equal(np.asarray(o0), r0)
    np.testing.assert_array_equal(np.asarray(o1), r1)


def test_median_matches_oracle(rng):
    _, _, vL, _, disp = _random_scene(rng)
    mo, mj = _margins(vL)
    ours = np.asarray(median_filter(jnp.asarray(disp, jnp.float32),
                                    jnp.asarray(vL), mj, 1))
    ref = oracle.median6(disp, vL, mo)
    np.testing.assert_array_equal(ours, ref)


def test_propagate_bounds_matches_oracle(rng):
    _, _, vL, vR, disp = _random_scene(rng)
    mo0, mj0 = _margins(vL)
    mo1, mj1 = _margins(vR)
    BL, BR = propagate_bounds(jnp.asarray(disp, jnp.float32),
                              jnp.asarray(vL), mj0, mj1)
    BLo, BRo = oracle.set_boundary_smooth(disp, vL, mo0, mo1)
    YL, YR, XL, XR = mo0
    sel = np.zeros(vL.shape, bool)
    sel[YL:YR + 1, XL:XR + 1] = True
    sel &= vL  # meaningful only at mask-valid pixels
    np.testing.assert_allclose(np.asarray(BL)[sel], BLo[sel])
    np.testing.assert_allclose(np.asarray(BR)[sel], BRo[sel])


def test_refine_single_iteration_matches_oracle(rng):
    imgL, imgR, vL, _, disp = _random_scene(rng, H=24, W=32, hole_p=0.15)
    # keep disparities small so the 3x3 windows stay interior
    disp = np.where(disp == NOMATCH, NOMATCH, np.clip(disp, -2, 2))
    mo, mj = _margins(vL)
    ours = np.asarray(disparity_refine(
        jnp.asarray(disp, jnp.float32), jnp.asarray(imgL), jnp.asarray(imgR),
        mj, iterations=1, ws=0.03, s_cap=32, band=8))
    ref = oracle.refine_iteration(disp, imgL.astype(np.float64),
                                  imgR.astype(np.float64), mo, 0.03)
    # f32 NCC vs f64: allow small diffs; structure must match
    valid = disp != NOMATCH
    np.testing.assert_allclose(ours[valid], ref[valid], atol=2e-2)
    np.testing.assert_array_equal(ours[~valid], ref[~valid])


def test_refine_converges_on_smooth_scene(rng):
    """Multiple iterations keep disparities bounded and NOMATCH fixed."""
    imgL, imgR, vL, _, disp = _random_scene(rng, H=24, W=32)
    disp = np.where(disp == NOMATCH, NOMATCH, np.clip(disp, -2, 2))
    mo, mj = _margins(vL)
    out = np.asarray(disparity_refine(
        jnp.asarray(disp, jnp.float32), jnp.asarray(imgL), jnp.asarray(imgR),
        mj, iterations=30, ws=0.03, s_cap=32, band=8))
    valid = disp != NOMATCH
    assert np.array_equal(out == NOMATCH, ~valid)
    assert np.isfinite(out[valid]).all()
    assert np.abs(out[valid]).max() < 40


def test_banded_sweep_matches_unbanded(rng):
    H, W = 96, 40
    imgL = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    imgR = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    vR = np.ones((H, W), bool)
    act = np.zeros((H, W), bool)
    act[4:-4, 4:-4] = True
    lo = rng.integers(0, W // 2, (H, W)).astype(np.int32)
    hi = lo + rng.integers(0, 8, (H, W)).astype(np.int32)
    a = ncc_sweep_match(jnp.asarray(imgL), jnp.asarray(imgR), jnp.asarray(vR),
                        jnp.asarray(act), jnp.asarray(lo), jnp.asarray(hi),
                        2, band=0)
    b = ncc_sweep_match(jnp.asarray(imgL), jnp.asarray(imgR), jnp.asarray(vR),
                        jnp.asarray(act), jnp.asarray(lo), jnp.asarray(hi),
                        2, band=16)
    np.testing.assert_array_equal(np.asarray(a.disparity),
                                  np.asarray(b.disparity))


def test_window_slots_binshift_equals_gather(rng):
    """The gather-free window extractor is bitwise-equal to
    take_along_axis, including clipped / fully-out-of-range starts."""
    from reconstruction_tpu.stereo.refine import _window_slots_binshift
    H, W, S, MINI = 37, 53, 128, 32
    cv = jnp.asarray(rng.uniform(0, 1, (H, W, S)).astype(np.float32))
    j0 = rng.integers(-80, S + 40, (H, W)).astype(np.int32)
    j0[rng.uniform(size=(H, W)) < 0.05] = -(1 << 14)   # NOMATCH-style
    j0[rng.uniform(size=(H, W)) < 0.05] = (1 << 14)
    j0 = jnp.asarray(j0)
    ks = jnp.arange(MINI, dtype=jnp.int32)
    idx = j0[:, :, None] + ks[None, None, :]
    ok = (idx >= 0) & (idx < S)
    ref = jnp.where(
        ok, jnp.take_along_axis(cv, jnp.clip(idx, 0, S - 1), axis=2), 0.5)
    out = _window_slots_binshift(cv, j0, MINI, S)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_tiled_sweep_matches_unbanded(rng):
    H, W = 96, 64
    imgL = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    imgR = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    vR = np.ones((H, W), bool)
    act = np.zeros((H, W), bool)
    act[4:-4, 4:-4] = True
    lo = rng.integers(0, W // 2, (H, W)).astype(np.int32)
    hi = lo + rng.integers(0, 8, (H, W)).astype(np.int32)
    a = ncc_sweep_match(jnp.asarray(imgL), jnp.asarray(imgR), jnp.asarray(vR),
                        jnp.asarray(act), jnp.asarray(lo), jnp.asarray(hi),
                        2, band=0)
    b = ncc_sweep_match(jnp.asarray(imgL), jnp.asarray(imgR), jnp.asarray(vR),
                        jnp.asarray(act), jnp.asarray(lo), jnp.asarray(hi),
                        2, band=16, tile=16)
    np.testing.assert_array_equal(np.asarray(a.disparity),
                                  np.asarray(b.disparity))
    # uneven tile/band divisions
    c = ncc_sweep_match(jnp.asarray(imgL), jnp.asarray(imgR), jnp.asarray(vR),
                        jnp.asarray(act), jnp.asarray(lo), jnp.asarray(hi),
                        2, band=28, tile=24)
    np.testing.assert_array_equal(np.asarray(a.disparity),
                                  np.asarray(c.disparity))


def _drift_scene(rng, H=12, W=120, d_true=20, wavelength=60.0):
    """Sinusoidal texture (wavelength > 2*d_true) whose true disparity is
    +d_true but whose initial disparity is 0: the 3x3 NCC of a sinusoid
    is ~cos of the phase offset, a SINGLE smooth basin over the whole
    search range, so the photometric term pulls ~0.4 px/iteration toward
    the true match for dozens of sweeps — deterministic sustained drift
    past the static +-14-slot mini-window budget (a rough random texture
    instead makes pixels chase spurious local minima and amplifies
    f32-vs-f64 tie flips chaotically)."""
    x = np.arange(W, dtype=np.float64)
    rowL = 128.0 + 100.0 * np.sin(2 * np.pi * x / wavelength)
    rowR = 128.0 + 100.0 * np.sin(2 * np.pi * (x - d_true) / wavelength)
    imgL = np.repeat(rowL[None, :, None], H, 0).repeat(3, 2).astype(np.float32)
    imgR = np.repeat(rowR[None, :, None], H, 0).repeat(3, 2).astype(np.float32)
    # Valid region keeps every drifted 3x3 NCC window interior (the
    # oracle zero-pads outside the image; the shift path pads with gray).
    vL = np.zeros((H, W), bool)
    vL[2:-2, 18:W - 25] = True
    # Matched pixels start one ring INSIDE the margin box: the ring
    # pixels are NOMATCH (excluded from the smoothness term) rather than
    # frozen zeros that would drag the drifting interior back.
    disp = np.full((H, W), NOMATCH, np.float64)
    disp[3:-3, 19:W - 26] = 0.0
    return imgL, imgR, vL, disp


def test_refine_multi_iteration_matches_full_recompute_oracle(rng):
    """260 refinement sweeps on a scene whose disparity legitimately
    drifts ~20 px, vs the sequential oracle that recomputes NCC at the
    current disparity every iteration (`CStereoMatching.cpp:624-679`).

    The exact comparison runs in float64 (`disparity_refine` follows the
    input dtype): the slow drift dynamics amplify per-sweep cost noise
    ~5e4x over the run, so f32-vs-f64 comparisons measure dtype phase
    lag, not window semantics; in f64 both sides' noise floor (~1e-10)
    stays invisible.  The production f32 run is then checked where the
    dynamics have converged (fixed points are dtype-stable).
    """
    import jax

    imgL, imgR, vL, disp = _drift_scene(rng)
    mo, mj = _margins(vL)
    iters, ws, d_true = 260, 0.01, 20.0
    ref = oracle.refine_full(disp, imgL.astype(np.float64),
                             imgR.astype(np.float64), mo, ws, iters)

    # The scene must genuinely drift beyond the static mini-window
    # budget (32 slots centered on the initial anchor serve one-sided
    # drift up to ~+14 slots; beyond that reads go stale).
    valid = disp != NOMATCH
    drift = np.abs(ref - disp)[valid]
    assert drift.max() > 15.5, drift.max()

    # recenter_every=1 re-extracts the window at the current anchor every
    # sweep: each xi lookup then reads exactly the cost the reference
    # recomputes, no matter how far d has drifted (a weak-texture pixel
    # can jump toward the neighbor average by many slots in ONE
    # iteration, so k=1 is the verification-exact mode).
    with jax.enable_x64():
        ours64 = np.asarray(disparity_refine(
            jnp.asarray(disp, jnp.float64), jnp.asarray(imgL, jnp.float64),
            jnp.asarray(imgR, jnp.float64), mj, iterations=iters, ws=ws,
            s_cap=128, band=8, drift=32, recenter_every=1))
    np.testing.assert_array_equal(ours64[~valid], ref[~valid])
    err = np.abs(ours64 - ref)[valid]
    assert err.max() < 1e-4, (err.max(), np.quantile(err, 0.99))

    # Drift-budget accounting: total realized drift stays inside the
    # banded volume's filled margin (drift=32).
    realized = np.abs(ours64 - disp)[valid]
    assert realized.max() < 32 + 2, realized.max()

    # Production f32 run: the trajectory statistics must track the
    # oracle (pointwise f32-vs-f64 comparison only measures phase lag on
    # this still-sliding field — the f64 equality above is the exact
    # semantic check).
    ours32 = np.asarray(disparity_refine(
        jnp.asarray(disp, jnp.float32), jnp.asarray(imgL), jnp.asarray(imgR),
        mj, iterations=iters, ws=ws, s_cap=128, band=8,
        drift=32, recenter_every=1))
    drift32 = np.abs(ours32 - disp)[valid]
    assert abs(np.median(drift32) - np.median(drift)) < 1.0
    assert abs(drift32.max() - drift.max()) < 2.0

    # Without recentering the window goes stale where drift exceeds its
    # ~+14 slots — quantifying why recenter_every exists.
    with jax.enable_x64():
        stale = np.asarray(disparity_refine(
            jnp.asarray(disp, jnp.float64), jnp.asarray(imgL, jnp.float64),
            jnp.asarray(imgR, jnp.float64), mj, iterations=iters, ws=ws,
            s_cap=128, band=8, drift=32, recenter_every=0))
    assert np.abs(stale - ref)[valid].max() > 1.0


def test_refine_multi_iteration_realistic_scene_vs_oracle(rng):
    """Level-3-scale iteration counts on a realistic textured scene:
    drift stays small and the default (no recenter) path matches the
    full-recompute oracle.  Runs in f64 and in two regimes, because the
    refinement map is CHAOTIC at pixels that oscillate around the
    discrete-argmin tie: there, summation-order noise (box-sum NCC vs
    the oracle's explicit dot, ~1e-15 in f64) amplifies ~1.4x per sweep
    — any arithmetic reordering diverges pointwise eventually (the
    reference's own OpenMP reduction order would too).  So: exact
    equality at 60 sweeps (amplification still below 1e-8), aggregate
    equality at the full 120 (chaotic sites are isolated pixels)."""
    import jax

    imgL, imgR, vL, _, disp = _random_scene(rng, H=24, W=40, hole_p=0.1)
    disp = np.where(disp == NOMATCH, NOMATCH,
                    np.clip(disp, -2, 2)).astype(np.float64)
    mo, mj = _margins(vL)
    valid = disp != NOMATCH

    def run(iters):
        with jax.enable_x64():
            return np.asarray(disparity_refine(
                jnp.asarray(disp, jnp.float64), jnp.asarray(imgL, jnp.float64),
                jnp.asarray(imgR, jnp.float64), mj, iterations=iters,
                ws=0.03, s_cap=32, band=8))

    ref60 = oracle.refine_full(disp, imgL.astype(np.float64),
                               imgR.astype(np.float64), mo, 0.03, 60)
    ours60 = run(60)
    np.testing.assert_array_equal(ours60[~valid], ref60[~valid])
    err60 = np.abs(ours60 - ref60)[valid]
    assert err60.max() < 1e-6, (err60.max(), np.quantile(err60, 0.99))

    ref120 = oracle.refine_full(ref60, imgL.astype(np.float64),
                                imgR.astype(np.float64), mo, 0.03, 60)
    ours120 = run(120)
    err120 = np.abs(ours120 - ref120)[valid]
    assert np.median(err120) < 1e-6
    assert np.quantile(err120, 0.75) < 1e-3
    assert (err120 > 0.05).mean() < 0.10, (err120.max(),
                                           (err120 > 0.05).mean())


def test_refine_auto_recenter_bounds_drift_at_level3_iters(rng):
    """Production drift protection (recenter_every=-1: ONE mid-run
    window re-extraction, the match_one_level default) at the level-3
    iteration budget (120 sweeps): on a sustained-drift scene the auto
    mode must track the full-recompute oracle strictly better than the
    static window, and its realized drift must stay within the banded
    volume's fill margin."""
    import jax

    imgL, imgR, vL, disp = _drift_scene(rng)
    mo, mj = _margins(vL)
    iters, ws = 120, 0.01
    ref = oracle.refine_full(disp, imgL.astype(np.float64),
                             imgR.astype(np.float64), mo, ws, iters)
    valid = disp != NOMATCH

    def run(rc):
        with jax.enable_x64():
            return np.asarray(disparity_refine(
                jnp.asarray(disp, jnp.float64),
                jnp.asarray(imgL, jnp.float64),
                jnp.asarray(imgR, jnp.float64), mj, iterations=iters,
                ws=ws, s_cap=128, band=8, drift=32, recenter_every=rc))

    auto, stale = run(-1), run(0)
    err_auto = np.abs(auto - ref)[valid]
    err_stale = np.abs(stale - ref)[valid]
    # the scene must stress the static budget at all for this to mean
    # anything
    assert np.abs(ref - disp)[valid].max() > 10.0
    assert err_auto.max() < err_stale.max() * 0.5, (
        err_auto.max(), err_stale.max())
    assert np.median(err_auto) <= np.median(err_stale) + 1e-12
    # bounded by the banded volume's fill margin
    assert np.abs(auto - disp)[valid].max() < 32 + 2


def _refine_scene(rng, H=48, W=40):
    imgL = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    imgR = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    disp = rng.integers(-2, 3, (H, W)).astype(np.float32)
    valid = np.zeros((H, W), bool)
    valid[3:-3, 3:-3] = True
    disp[~valid] = NOMATCH
    disp[rng.uniform(size=(H, W)) < 0.15] = NOMATCH
    return imgL, imgR, disp, valid


def test_refine_minicv_matches_gather_path(rng):
    imgL, imgR, disp, valid = _refine_scene(rng)
    m = find_margin(jnp.asarray(valid), 2)
    a = disparity_refine(jnp.asarray(disp), jnp.asarray(imgL),
                         jnp.asarray(imgR), m, iterations=24,
                         s_cap=32, band=8, use_minicv=False)
    b = disparity_refine(jnp.asarray(disp), jnp.asarray(imgL),
                         jnp.asarray(imgR), m, iterations=24,
                         s_cap=32, band=8, use_minicv=True)
    an, bn = np.asarray(a), np.asarray(b)
    close = np.isclose(an, bn, atol=1e-4)
    assert close.mean() > 0.999, (1 - close.mean())
    np.testing.assert_array_equal(an == NOMATCH, bn == NOMATCH)


def test_resolve_recenter_auto():
    from reconstruction_tpu.stereo.refine import resolve_recenter
    # auto = one mid-run re-extraction, aligned to a multiple of t=6
    assert resolve_recenter(120, -1) == 60
    assert resolve_recenter(90, -1) == 48
    assert resolve_recenter(30, -1) == 18
    assert resolve_recenter(120, 0) == 0   # explicit off
    assert resolve_recenter(120, 30) == 30
    # explicit alignment override
    assert resolve_recenter(24, -1, t=6) == 12
    assert resolve_recenter(30, -1, t=10) == 20

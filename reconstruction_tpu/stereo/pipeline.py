"""Per-level and per-pair stereo drivers.

Reproduces the reference's per-level recipe (`CStereoMatching.cpp:36-113`,
the behavioral contract in SURVEY.md section 3.2), in exact stage order:

  init/guided match (both dirs) -> smoothness -> ordering -> uniqueness ->
  rematch (bound propagation inside) -> uniqueness -> median -> refine
  (30 + 30*level iters) -> uniqueness

and the per-pair driver `MatchAllLayer` (`:15-34`): rectify -> pyramids ->
levels coarse-to-fine -> triangulate.  Everything per-level runs inside
one jit; both directions are processed as a batch where possible.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.config import NOMATCH, ReconstructionConfig
from reconstruction_tpu.core.morphology import erode_mask, valid_mask
from reconstruction_tpu.core.pyramid import build_pyramid, quantize_u8
from reconstruction_tpu.core.rectify import RectifyResult, rectify_pair
from reconstruction_tpu.core.remap import rectify_map, remap_bilinear
from reconstruction_tpu.stereo.constraints import (
    median_filter, ordering_constraint, propagate_bounds,
    smoothness_constraint, uniqueness_constraint)
from reconstruction_tpu.stereo.margins import Margins, find_margin
from reconstruction_tpu.stereo.matching import (
    brute_force_match, guided_match, rematch)
from reconstruction_tpu.stereo.refine import disparity_refine
from reconstruction_tpu.stereo.triangulate import PointCloud, disparity_to_cloud


class LevelState(NamedTuple):
    """Both-direction disparities after one pyramid level."""

    disp0: jnp.ndarray  # view0 -> view1
    disp1: jnp.ndarray  # view1 -> view0
    # Realized refine drift telemetry: max |d_refined - d_pre_refine|
    # over pixels valid in both (scalar, slots).  Surfaces stale-window
    # captures: the mini-CV window covers ~+-12 slots of its anchors and
    # the banded volume ~+-16 beyond the band range, so drift
    # approaching those budgets means the refine read neutral costs.
    refine_drift0: Optional[jnp.ndarray] = None
    refine_drift1: Optional[jnp.ndarray] = None
    # The integer disparities after the constraints, before the median
    # and refine: what the subpixel half started from.
    pre_refine0: Optional[jnp.ndarray] = None
    pre_refine1: Optional[jnp.ndarray] = None


def _stk(a, b):
    """Stack two pytrees leaf by leaf on a leading 2-lane axis."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.stack([jnp.asarray(x), jnp.asarray(y)]), a, b)


def both_directions(img0, img1, mask0, mask1, radius):
    """Per-direction operands stacked on a leading 2-lane axis (lane 0 =
    view0->view1, lane 1 = the swap), plus both views' margins."""
    v0 = valid_mask(mask0)
    v1 = valid_mask(mask1)
    m0 = find_margin(v0, radius)
    m1 = find_margin(v1, radius)
    lanes = dict(A_img=_stk(img0, img1), B_img=_stk(img1, img0),
                 A_v=_stk(v0, v1), B_v=_stk(v1, v0),
                 A_m=_stk(m0, m1), B_m=_stk(m1, m0))
    return lanes, m0, m1


def level_integer(lanes, m0, m1, coarse, level, radius, offset):
    """The integer half of one level: init/guided match -> smoothness ->
    ordering -> uniqueness -> rematch -> uniqueness
    (`CStereoMatching.cpp:36-88`).  Returns (disp0, disp1)."""
    A_img, B_img = lanes["A_img"], lanes["B_img"]
    A_v, B_v, A_m, B_m = lanes["A_v"], lanes["B_v"], lanes["A_m"], lanes["B_m"]

    def seg_match(c, x):
        if level == 0:
            ai, bi, av, bv, am, bm = x
            d = brute_force_match(ai, bi, av, bv, am, bm, radius)
        else:
            ai, bi, av, bv, am, bm, ac = x
            d = guided_match(ai, bi, av, bv, ac, am, bm, radius, offset)
        d = smoothness_constraint(d, am)
        d = ordering_constraint(d, am)
        return c, d

    if level == 0:
        xs = (A_img, B_img, A_v, B_v, A_m, B_m)
    else:
        assert coarse is not None
        xs = (A_img, B_img, A_v, B_v, A_m, B_m,
              _stk(coarse.disp0, coarse.disp1))
    _, ds = jax.lax.scan(seg_match, 0, xs)
    d0, d1 = ds[0], ds[1]
    d0, d1 = uniqueness_constraint(d0, d1, m0, m1)

    def seg_rematch(c, x):
        ai, bi, av, bv, am, bm, d = x
        bl, br = propagate_bounds(d, av, am, bm)
        return c, rematch(ai, bi, av, bv, d, bl, br, am, radius)

    _, ds = jax.lax.scan(seg_rematch, 0,
                         (A_img, B_img, A_v, B_v, A_m, B_m, _stk(d0, d1)))
    d0, d1 = ds[0], ds[1]
    return uniqueness_constraint(d0, d1, m0, m1)


def level_refine(lanes, m0, m1, d0, d1, ws, refine_iters, median_iters,
                  s_cap, recenter_every):
    """The subpixel half of one level: median -> refine -> uniqueness
    (`CStereoMatching.cpp:89-110`), with the drift telemetry."""

    def drift(pre, post):
        """p99 of |d_refined - d_pre| over pixels valid in both.  p99,
        not max: isolated bad matches legitimately get dragged tens of
        slots by the smoothness term (the reference does the same,
        `CStereoMatching.cpp:652-672`) — the window budget only matters
        when the BULK of pixels drift."""
        ok = (pre != NOMATCH) & (post != NOMATCH)
        mag = jnp.where(ok, jnp.abs(post - pre), 0.0)
        # p99 over VALID pixels only: invalid entries sit at 0.0, so the
        # valid p99 is the all-pixel percentile at rank
        # 100 - 1*valid_fraction (drift magnitudes are >= 0, zeros sort
        # below any positive drift).
        frac = jnp.mean(ok.astype(jnp.float32))
        return jnp.percentile(mag, 100.0 - frac)

    def seg_refine(c, x):
        ai, bi, av, am, d = x
        d = median_filter(d, av, am, median_iters)
        pre = d
        d = disparity_refine(d, ai, bi, am, refine_iters, ws, s_cap,
                             recenter_every=recenter_every)
        return c, (d, drift(pre, d))

    _, (ds, drs) = jax.lax.scan(
        seg_refine, 0, (lanes["A_img"], lanes["B_img"], lanes["A_v"],
                        lanes["A_m"], _stk(d0, d1)))
    d0, d1 = ds[0], ds[1]
    d0, d1 = uniqueness_constraint(d0, d1, m0, m1)
    return LevelState(disp0=d0, disp1=d1,
                      refine_drift0=drs[0], refine_drift1=drs[1])


@partial(jax.jit, static_argnames=("level", "radius", "offset", "ws",
                                   "refine_iters", "median_iters", "s_cap",
                                   "recenter_every"))
def match_one_level(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    mask0: jnp.ndarray,
    mask1: jnp.ndarray,
    coarse: Optional[LevelState],
    level: int,
    radius: int = 2,
    offset: int = 2,
    ws: float = 0.03,
    refine_iters: int = 30,
    median_iters: int = 1,
    s_cap: int = 128,
    recenter_every: int = -1,
) -> LevelState:
    """One pyramid level for both directions (`MatchOneLayer`,
    `CStereoMatching.cpp:36-113`): the integer half, then the subpixel
    half, in one program.

    The per-direction stages run under `lax.scan` over a 2-lane
    direction axis instead of two inline copies: each stage body traces
    ONCE, which halves the compiled executable.  The scan runs the
    directions sequentially, exactly like the reference's back-to-back
    calls.  The joint uniqueness cascades stay unbatched between
    segments (they couple the two directions)."""
    lanes, m0, m1 = both_directions(img0, img1, mask0, mask1, radius)
    d0, d1 = level_integer(lanes, m0, m1, coarse, level, radius, offset)
    state = level_refine(lanes, m0, m1, d0, d1, ws, refine_iters,
                          median_iters, s_cap, recenter_every)
    return state._replace(pre_refine0=d0, pre_refine1=d1)


@dataclass
class PairResult:
    """Output of one camera pair."""

    disparity: np.ndarray           # finest-level view0->view1 disparity
    cloud: PointCloud
    rectification: RectifyResult
    margins0: Margins
    margins1: Margins
    # Rectified working-resolution images/masks (uint8 host arrays),
    # kept so texturing and the isoutput dumps reuse the remap already
    # paid inside match_pair (re-remapping cost ~60 s of the r2 bench's
    # texture stage: 2.5M-pixel gathers x 8 arrays).
    rect_images: Tuple[np.ndarray, np.ndarray] = None
    rect_masks: Tuple[np.ndarray, np.ndarray] = None
    # Per-level realized refine drift, (levels, 2 directions) slots —
    # telemetry for the mini-CV window budget (see LevelState).
    refine_drift: np.ndarray = None
    # Eroded rectified masks (the reference's in-place `cam.mask` after
    # `CStereoMatching.cpp:157-158`) — dedup's bucket gate reads THESE
    # (`CCloudOptimization.cpp:188,217`), while texturing wants the
    # pre-erosion coverage above.
    rect_masks_eroded: Tuple[np.ndarray, np.ndarray] = None


def remap_pair_views(
    cfg: ReconstructionConfig,
    image0: np.ndarray,
    image1: np.ndarray,
    mask0: np.ndarray,
    mask1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    rect: RectifyResult,
    working: Tuple[int, int],
    use_native: bool,
):
    """Remap both views to the rectified working grid
    (`CStereoMatching.cpp:140-158`).  On the native backend the warp
    runs on the host, which needs the rectified images for texturing
    anyway; only the quantized uint8 results upload.  On the jax path
    the warp runs on the default device (callers pick it with
    `jax.default_device`).

    Returns (imgs, masks_eroded, raw_masks, host_imgs, host_raw_masks,
    host_eroded); the first three are device arrays (f32 on the uint8
    grid), the host lists are uint8/bool and empty on the jax path.
    """
    from reconstruction_tpu.core.morphology import (
        erode_binary_np, ellipse_kernel, pack_mask_bits, unpack_mask_bits)
    imgs, masks, raw_masks = [], [], []
    host_imgs, host_raw_masks, host_eroded = [], [], []
    if use_native:
        from reconstruction_tpu import native as native_mod
    se = cfg.stereo.mask_erode_base * (1 << (cfg.pyramid_levels - 1))
    for img, msk, Rr, P in ((image0, mask0, rect.R1, rect.P1_scaled),
                            (image1, mask1, rect.R2, rect.P2_scaled)):
        K = K0 if img is image0 else K1
        mx, my = rectify_map(K, Rr, P, working)
        if use_native:
            im_h = native_mod.remap_bilinear(np.asarray(img, np.float32),
                                             mx, my)
            mk_h = native_mod.remap_bilinear(np.asarray(msk, np.float32),
                                             mx, my)
            im_u8 = np.clip(np.round(im_h), 0, 255).astype(np.uint8)
            mk_u8 = np.clip(np.round(mk_h), 0, 255).astype(np.uint8)
            host_imgs.append(im_u8)
            host_raw_masks.append(mk_u8)
            im = jnp.asarray(im_u8).astype(jnp.float32)
            # Erode on HOST (exact twin of the device conv-erode,
            # erode_binary_np) and ship the mask BITPACKED: erode_mask
            # thresholds before eroding, so the device-side mask is
            # binary either way and every downstream consumer
            # (valid_mask per level, triangulation, dedup gate) reads
            # thresholded values.  The host already holds the finest
            # mask, so it is never fetched back.
            er_h = erode_binary_np(mk_u8 >= 255, ellipse_kernel(se, se))
            host_eroded.append(er_h)
            masks.append(unpack_mask_bits(jnp.asarray(pack_mask_bits(er_h)),
                                          er_h.shape[1]))
            raw_masks.append(None)  # grayscale mask stays host-only
            imgs.append(im)  # already on the uint8 grid
        else:
            im = remap_bilinear(jnp.asarray(img, jnp.float32),
                                jnp.asarray(mx), jnp.asarray(my))
            mk = remap_bilinear(jnp.asarray(msk, jnp.float32),
                                jnp.asarray(mx), jnp.asarray(my))
            raw_masks.append(mk)   # pre-erosion (texturing uses this)
            mk = erode_mask(mk, se)
            imgs.append(quantize_u8(im))
            masks.append(mk)
    return imgs, masks, raw_masks, host_imgs, host_raw_masks, host_eroded


def match_pair(
    cfg: ReconstructionConfig,
    image0: np.ndarray,
    image1: np.ndarray,
    mask0: np.ndarray,
    mask1: np.ndarray,
    K0: np.ndarray,
    Rt0: np.ndarray,
    K1: np.ndarray,
    Rt1: np.ndarray,
) -> PairResult:
    """Full per-pair pipeline (`MatchAllLayer` body,
    `CStereoMatching.cpp:17-32`): rectify + remap at working resolution,
    mask erosion, pyramids, per-level matching, triangulation.

    Images/masks are original-resolution host arrays (BGR / [0,255]).
    Equivalent to match_pair_finish(match_pair_dispatch(...)); the split
    form lets the orchestrator overlap the fetch with the next pair.
    """
    return match_pair_finish(match_pair_dispatch(
        cfg, image0, image1, mask0, mask1, K0, Rt0, K1, Rt1))


def match_pair_dispatch(
    cfg: ReconstructionConfig,
    image0: np.ndarray,
    image1: np.ndarray,
    mask0: np.ndarray,
    mask1: np.ndarray,
    K0: np.ndarray,
    Rt0: np.ndarray,
    K1: np.ndarray,
    Rt1: np.ndarray,
) -> "PairDeviceWork":
    """Host remap + async dispatch of all level programs for one pair
    (no device->host fetch; see PairDeviceWork)."""
    origin_size = (image0.shape[1], image0.shape[0])
    working = cfg.finest_size
    rect = rectify_pair(K0, Rt0, K1, Rt1, origin_size, working)

    from reconstruction_tpu.cloud.backend import resolve_backend
    use_native = resolve_backend(cfg.cloud.backend) == "native"
    if use_native:
        from reconstruction_tpu import native as native_mod
        use_native = native_mod.available()

    (imgs, masks, raw_masks, host_imgs, host_raw_masks,
     host_eroded) = remap_pair_views(
        cfg, image0, image1, mask0, mask1, K0, K1, rect, working,
        use_native)

    pyr0 = build_pyramid(imgs[0], cfg.pyramid_levels)
    pyr1 = build_pyramid(imgs[1], cfg.pyramid_levels)
    mpyr0 = [quantize_u8(m) for m in build_pyramid(masks[0], cfg.pyramid_levels)]
    mpyr1 = [quantize_u8(m) for m in build_pyramid(masks[1], cfg.pyramid_levels)]

    state: Optional[LevelState] = None
    drifts = []
    for level in range(cfg.pyramid_levels):
        state = match_one_level(
            quantize_u8(pyr0[level]), quantize_u8(pyr1[level]),
            mpyr0[level], mpyr1[level], state, level,
            radius=cfg.stereo.block_radius,
            offset=cfg.stereo.disparity_offset,
            ws=cfg.stereo.refine_ws,
            refine_iters=cfg.refine_iterations(level),
            median_iters=cfg.stereo.median_iterations,
            recenter_every=cfg.stereo.refine_recenter_every,
        )
        drifts.append((state.refine_drift0, state.refine_drift1))

    finest = cfg.pyramid_levels - 1
    v0 = valid_mask(mpyr0[finest])
    m0 = find_margin(v0, cfg.stereo.block_radius)
    m1 = find_margin(valid_mask(mpyr1[finest]), cfg.stereo.block_radius)
    scale = cfg.lowest_level_size[0] / origin_size[0] * (1 << finest)

    return PairDeviceWork(
        cfg=cfg, rect=rect, state=state, drifts=drifts,
        pyr0_finest=pyr0[finest], mpyr0_finest=mpyr0[finest],
        masks=masks, raw_masks=raw_masks, m0=m0, m1=m1, scale=scale,
        use_native=use_native, host_imgs=host_imgs,
        host_raw_masks=host_raw_masks, imgs=imgs,
        host_eroded=host_eroded)


@dataclass
class PairDeviceWork:
    """In-flight device state of one pair: all level programs DISPATCHED
    (async), nothing fetched.  `match_pair_finish` performs the packed
    fetch + triangulation — split out so the orchestrator can fetch
    pair i while pair i+1's programs execute."""

    cfg: ReconstructionConfig
    rect: RectifyResult
    state: LevelState
    drifts: list
    pyr0_finest: jnp.ndarray
    mpyr0_finest: jnp.ndarray
    masks: list
    raw_masks: list
    m0: Margins
    m1: Margins
    scale: float
    use_native: bool
    host_imgs: list
    host_raw_masks: list
    imgs: list
    # Host bool eroded masks (native mode): the finest-level mask and
    # dedup gates read these instead of fetching device copies.
    host_eroded: list = None


@jax.jit
def _quantize_disp(disp0):
    """Range-adaptive int16 fixed-point encoding (see match_pair_finish)."""
    dabs = jnp.where(disp0 == NOMATCH, 0.0, jnp.abs(disp0))
    dmax = jnp.maximum(jnp.max(dabs), 1.0)
    disp_q = jnp.where(
        disp0 == NOMATCH, jnp.int32(-32768),
        jnp.clip(jnp.round(disp0 * (32000.0 / dmax)),
                 -32000, 32000).astype(jnp.int32)).astype(jnp.int16)
    return disp_q, dmax


def match_pair_finish(work: PairDeviceWork) -> PairResult:
    """Packed fetch + host-side triangulation for a dispatched pair."""
    cfg = work.cfg
    rect, state, drifts = work.rect, work.state, work.drifts
    mpyr0_finest = work.mpyr0_finest
    m0, m1, scale = work.m0, work.m1, work.scale
    use_native = work.use_native
    host_imgs, host_raw_masks = work.host_imgs, work.host_raw_masks
    masks, raw_masks, imgs = work.masks, work.raw_masks, work.imgs

    # ONE packed device->host transfer for everything the host needs.
    # The eroded masks only gate dedup's buckets, so they stay on device
    # unless the isdelete path is enabled.  On the native backend the
    # pair CLOUD is triangulated on HOST from the fetched disparity +
    # finest mask (the colors ARE the already-host rectified image), so
    # no xyz/colors fetch is needed.
    from reconstruction_tpu.utils.transfer import fetch_packed
    # Disparity ships as range-adaptive int16 fixed point: |d|max maps
    # to 32000, so the quantization step is |d|max/32000 (~0.002 slot
    # at the bench's ~65-slot range) — far below the refine's subpixel
    # noise — while halving the dominant fetch payload.  NOMATCH rides
    # as -32768.  The quantizer and the u8 casts run INSIDE two jitted
    # programs (the quantizer + the packer).
    host_eroded = work.host_eroded or []
    disp_q, dmax = _quantize_disp(state.disp0)
    fetch = [disp_q, dmax, jnp.asarray(drifts, jnp.float32)]
    casts = [None, None, None]
    if cfg.cloud.dedup and not host_eroded:
        fetch += [masks[0], masks[1]]
        casts += ["u8", "u8"]
    if use_native:
        # The finest-level mask is the eroded mask itself (the pyramid's
        # finest entry is its input), which the host computed — only the
        # margins still come down (scalars).
        fetch += [jnp.stack([m0.YL, m0.YR, m0.XL, m0.XR])]
        casts += [None]
    if host_imgs:
        im0_h, im1_h = host_imgs
        rm0_h, rm1_h = host_raw_masks
    else:
        fetch += [imgs[0], imgs[1],
                  quantize_u8(raw_masks[0]), quantize_u8(raw_masks[1])]
        casts += ["u8", "u8", "u8", "u8"]
    out = fetch_packed(fetch, casts)
    disp_q_h, dmax_h, drifts_h = out[:3]
    disp_h = np.where(
        disp_q_h == -32768, np.float32(NOMATCH),
        disp_q_h.astype(np.float32) * (float(dmax_h) / 32000.0))
    pos = 3
    em0_h = em1_h = None
    if cfg.cloud.dedup and not host_eroded:
        em0_h, em1_h = out[pos:pos + 2]
        pos += 2
    elif cfg.cloud.dedup:
        em0_h = host_eroded[0].astype(np.uint8) * 255
        em1_h = host_eroded[1].astype(np.uint8) * 255
    if use_native:
        fmask_h = host_eroded[0].astype(np.uint8) * 255
        margins_h = out[pos]
        pos += 1
    if not host_imgs:
        im0_h, im1_h, rm0_h, rm1_h = out[pos:pos + 4]

    if use_native:
        from reconstruction_tpu.stereo.triangulate import disparity_to_cloud_np
        cloud = disparity_to_cloud_np(
            disp_h, fmask_h, im0_h, rect.Q, rect.R_final, rect.T_final,
            margins_h, scale, erode_frac=cfg.stereo.cloud_erode_frac)
    else:
        cloud = disparity_to_cloud(
            state.disp0, mpyr0_finest, quantize_u8(work.pyr0_finest),
            rect.Q, rect.R_final, rect.T_final, m0, scale,
            erode_frac=cfg.stereo.cloud_erode_frac,
        )

    return PairResult(
        disparity=disp_h,
        cloud=cloud,
        rectification=rect,
        margins0=m0,
        margins1=m1,
        rect_images=(im0_h, im1_h),
        rect_masks=(rm0_h, rm1_h),
        refine_drift=drifts_h,
        rect_masks_eroded=(em0_h, em1_h),
    )

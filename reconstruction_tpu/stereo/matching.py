"""Dense NCC matching: brute-force, coarse-guided, and hole rematch.

Replaces `LowestLevelInitialMatch` (`CStereoMatching.cpp:170-227`),
`HighLevelInitialMatch` (`:231-308`) and `Rematch` (`:499-570`).

Array design: instead of the reference's per-pixel candidate scans
(pointer-chasing over window vectors), all three matchers reduce to ONE
primitive — a sweep over uniform epipolar shifts `s` with a running
argmax.  For each shift the zero-mean NCC of every pixel against the
target column x+s is a handful of fused element-wise ops on (H, W) maps
(box-filter formulation of `WindowToVec`'s zero-mean dot,
`CManageData.cpp:81-90`):

    NCC_s(x) = (B_s(x) - n mu_L(x) mu_R(x+s)) / (norm_L(x) norm_R(x+s))
    B_s = box( sum_c L * shift_x(R, s) )

The sweep runs as a `lax.fori_loop` whose (traced) trip count is the
actual disparity range present in the per-pixel bounds — no gathers, no
data-dependent shapes, elementwise work that XLA fuses into one loop body.
Candidate order (ascending target column) and strict-> argmax update
reproduce the reference's first-maximum tie-breaking
(`CStereoMatching.cpp:213-217`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.stereo.margins import Margins
from reconstruction_tpu.stereo.ncc import shifted


class NccMoments(NamedTuple):
    """Per-pixel window statistics for the box-filter NCC."""

    mean: jnp.ndarray       # (H, W) window mean over (2r+1)^2 * C values
    inv_norm: jnp.ndarray   # (H, W) 1 / ||window - mean|| (0 -> 1)
    n: int                  # number of values per window


def _box_sum(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable (2r+1)^2 box sum with zero padding."""
    acc = x
    out = x
    for d in range(1, radius + 1):
        out = out + shifted(x, 0, d) + shifted(x, 0, -d)
    acc = out
    out = acc
    for d in range(1, radius + 1):
        out = out + shifted(acc, d, 0) + shifted(acc, -d, 0)
    return out


@partial(jax.jit, static_argnames=("radius",))
def ncc_moments(img: jnp.ndarray, radius: int) -> NccMoments:
    """Window mean and inverse norm maps for one image ((H, W, C) f32)."""
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[-1]
    n = (2 * radius + 1) ** 2 * C
    s1 = _box_sum(img.sum(-1), radius)
    s2 = _box_sum((img * img).sum(-1), radius)
    mean = s1 / n
    var = jnp.maximum(s2 - n * mean * mean, 0.0)
    norm = jnp.sqrt(var)
    inv = jnp.where(norm == 0, 1.0, 1.0 / jnp.where(norm == 0, 1.0, norm))
    return NccMoments(mean=mean, inv_norm=inv, n=n)


def _shift_x(a: jnp.ndarray, s: jnp.ndarray, W: int, fill: float = 0.0) -> jnp.ndarray:
    """out[..., x] = a[..., x+s] for traced s, zero fill out of range."""
    pad = [(0, 0)] * (a.ndim - 1) + [(W, W)]
    ap = jnp.pad(a, pad, constant_values=fill)
    off = W + s
    start = [jnp.zeros((), off.dtype)] * (a.ndim - 1) + [off]
    return jax.lax.dynamic_slice(ap, start, a.shape)


def _shift_x_pre(ap: jnp.ndarray, s: jnp.ndarray, W: int,
                 out_w: int) -> jnp.ndarray:
    """dynamic_slice form of _shift_x for a PRE-PADDED array (padding
    hoisted out of sweep loops so no per-iteration copies)."""
    off = W + s
    start = [jnp.zeros((), off.dtype)] * (ap.ndim - 1) + [off]
    shape = list(ap.shape)
    shape[-1] = out_w
    return jax.lax.dynamic_slice(ap, start, shape)


class SweepResult(NamedTuple):
    disparity: jnp.ndarray  # (H, W) f32, NOMATCH where unmatched
    score: jnp.ndarray      # (H, W) best NCC (-2 where none)


@partial(jax.jit, static_argnames=("radius", "band", "tile", "sblock"))
def ncc_sweep_match(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    validR: jnp.ndarray,
    active: jnp.ndarray,
    bound_lo: jnp.ndarray,
    bound_hi: jnp.ndarray,
    radius: int,
    band: int = 0,
    tile: int = 0,
    sblock: int = 1,
) -> SweepResult:
    """Argmax-NCC match of active left pixels against target columns in
    [bound_lo, bound_hi] (absolute, inclusive, per pixel).

    Args:
      imgL, imgR: (H, W, C) float32.
      validR: (H, W) bool target-pixel validity (mask == 255 test,
        `CStereoMatching.cpp:209-210`).
      active: (H, W) bool, which left pixels to match.
      bound_lo, bound_hi: (H, W) int32 absolute target-column bounds.
      radius: NCC window radius.
      band: if > 0, rows are processed in bands of this size, each band
        sweeping only ITS OWN shift range.  One pathological wide-bounds
        pixel then costs O(range x band x W) instead of O(range x H x W)
        — essential at fine pyramid levels where hole pixels can carry
        near-full-row search intervals (`HighLevelInitialMatch`'s
        fallthrough bounds, `CStereoMatching.cpp:259-288`).
      sblock: shifts per loop iteration (bit-identical for any K —
        same ascending-candidate select chain).  Production uses 1.

    Returns disparity d = t - x (reference convention) and the best score.
    A pixel matches only if some candidate scores > -1
    (`CStereoMatching.cpp:206,219`).
    """
    H, W = imgL.shape[:2]
    if band and band < H and tile and tile < W:
        return _ncc_sweep_match_tiled(imgL, imgR, validR, active,
                                      bound_lo, bound_hi, radius, band,
                                      tile, sblock)
    if band and band < H:
        return _ncc_sweep_match_banded(imgL, imgR, validR, active,
                                       bound_lo, bound_hi, radius, band,
                                       sblock)
    # Center values for f32 conditioning: zero-mean NCC is invariant to a
    # global constant offset, but the box-sum moment terms are not — keeping
    # raw magnitudes small preserves ~2 extra bits in the cancellation
    # (cross - n mu_L mu_R).
    imgL = imgL.astype(jnp.float32) - 128.0
    imgR = imgR.astype(jnp.float32) - 128.0
    momL = ncc_moments(imgL, radius)
    momR = ncc_moments(imgR, radius)
    n = momL.n
    x = jnp.arange(W, dtype=jnp.int32)[None, :]

    s_lo_px = jnp.where(active, bound_lo - x, jnp.int32(1 << 20))
    s_hi_px = jnp.where(active, bound_hi - x, jnp.int32(-(1 << 20)))
    any_active = active.any()
    s_min = jnp.where(any_active, s_lo_px.min(), 0)
    s_max = jnp.where(any_active, s_hi_px.max(), -1)
    s_min = jnp.clip(s_min, -(W - 1), W - 1)
    s_max = jnp.clip(s_max, -(W - 1), W - 1)

    validR_f = validR.astype(jnp.float32)
    imgLf = imgL if imgL.ndim == 3 else imgL[..., None]
    imgRf = imgR if imgR.ndim == 3 else imgR[..., None]

    # Pre-pad all shifted operands ONCE (loop bodies must not re-pad:
    # that would copy (H, 3W, C) buffers every iteration).  The extra
    # K-1 right pad keeps the K-wide block slices un-clamped at s_max.
    K = max(1, sblock)
    imgR_pad = jnp.pad(imgRf.transpose(2, 0, 1),
                       ((0, 0), (0, 0), (W, W + K - 1)))
    muR_pad = jnp.pad(momR.mean, ((0, 0), (W, W + K - 1)))
    invR_pad = jnp.pad(momR.inv_norm, ((0, 0), (W, W + K - 1)),
                       constant_values=1.0)
    validR_pad = jnp.pad(validR_f, ((0, 0), (W, W + K - 1)))

    def body(i, state):
        s0 = s_min + i * K
        best_score, best_t = state
        # ONE wide slice per operand covers shifts s0 .. s0+K-1.
        Rw = _shift_x_pre(imgR_pad, s0, W, W + K - 1)
        muw = _shift_x_pre(muR_pad, s0, W, W + K - 1)
        invw = _shift_x_pre(invR_pad, s0, W, W + K - 1)
        vw = _shift_x_pre(validR_pad, s0, W, W + K - 1)
        for k in range(K):
            s = s0 + k
            Rs = Rw[:, :, k:k + W].transpose(1, 2, 0)
            cross = _box_sum((imgLf * Rs).sum(-1), radius)
            score = ((cross - n * momL.mean * muw[:, k:k + W])
                     * momL.inv_norm * invw[:, k:k + W])
            t = x + s
            # shifts past a pixel's own bound_hi mask out here, so the
            # ragged last block needs no extra s <= s_max guard
            ok = (active & (vw[:, k:k + W] > 0.5)
                  & (t >= bound_lo) & (t <= bound_hi))
            score = jnp.where(ok, score, -2.0)
            upd = score > best_score
            best_score = jnp.where(upd, score, best_score)
            best_t = jnp.where(upd, t, best_t)
        return best_score, best_t

    init = (jnp.full((H, W), -1.0, jnp.float32), jnp.full((H, W), -1, jnp.int32))
    nblocks = jnp.maximum((s_max - s_min + K) // K, 0)
    best_score, best_t = jax.lax.fori_loop(0, nblocks, body, init)
    matched = best_t >= 0
    disp = jnp.where(matched, (best_t - x).astype(jnp.float32), float(NOMATCH))
    return SweepResult(disparity=disp, score=best_score)


def _ncc_sweep_match_banded(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    validR: jnp.ndarray,
    active: jnp.ndarray,
    bound_lo: jnp.ndarray,
    bound_hi: jnp.ndarray,
    radius: int,
    band: int,
    sblock: int = 1,
) -> SweepResult:
    """Row-banded sweep: each band of rows runs its own shift range."""
    H, W = imgL.shape[:2]
    if imgL.ndim == 2:
        imgL, imgR = imgL[..., None], imgR[..., None]
    C = imgL.shape[-1]
    imgL = imgL.astype(jnp.float32) - 128.0
    imgR = imgR.astype(jnp.float32) - 128.0

    nb = -(-H // band)
    Hp = nb * band
    halo = radius

    def banded(a, fill=0.0):
        """(H, W[, C]) -> (nb, band+2*halo, W[, C]) with halo rows."""
        pads = [(halo, Hp - H + halo)] + [(0, 0)] * (a.ndim - 1)
        ap = jnp.pad(a, pads, constant_values=fill)
        rows = (jnp.arange(nb) * band)[:, None] + jnp.arange(band + 2 * halo)[None, :]
        return ap[rows]

    bL = banded(imgL)
    bR = banded(imgR)
    bvR = banded(validR.astype(jnp.float32))
    bact = banded(active)[:, halo: halo + band]
    blo = banded(bound_lo)[:, halo: halo + band]
    bhi = banded(bound_hi)[:, halo: halo + band]

    x = jnp.arange(W, dtype=jnp.int32)[None, :]

    K = max(1, sblock)

    def band_fn(args):
        iL, iR, vR, act, lo, hi = args
        Hb = iL.shape[0]
        momL = ncc_moments(iL, radius)
        momR = ncc_moments(iR, radius)
        n = momL.n
        iR_pad = jnp.pad(iR.transpose(2, 0, 1),
                         ((0, 0), (0, 0), (W, W + K - 1)))
        muR_pad = jnp.pad(momR.mean, ((0, 0), (W, W + K - 1)))
        invR_pad = jnp.pad(momR.inv_norm, ((0, 0), (W, W + K - 1)),
                           constant_values=1.0)
        vR_pad = jnp.pad(vR, ((0, 0), (W, W + K - 1)))

        s_lo_px = jnp.where(act, lo - x, jnp.int32(1 << 20))
        s_hi_px = jnp.where(act, hi - x, jnp.int32(-(1 << 20)))
        any_act = act.any()
        s_min = jnp.clip(jnp.where(any_act, s_lo_px.min(), 0), -(W - 1), W - 1)
        s_max = jnp.clip(jnp.where(any_act, s_hi_px.max(), -1), -(W - 1), W - 1)

        def body(i, state):
            s0 = s_min + i * K
            best_score, best_t = state
            Rw = _shift_x_pre(iR_pad, s0, W, W + K - 1)
            muw = _shift_x_pre(muR_pad, s0, W, W + K - 1)
            invw = _shift_x_pre(invR_pad, s0, W, W + K - 1)
            vw = _shift_x_pre(vR_pad, s0, W, W + K - 1)
            for k in range(K):
                s = s0 + k
                Rs = Rw[:, :, k:k + W].transpose(1, 2, 0)
                cross = _box_sum((iL * Rs).sum(-1), radius)
                score = ((cross - n * momL.mean * muw[:, k:k + W])
                         * momL.inv_norm * invw[:, k:k + W])
                score = score[halo: halo + band]
                vs = vw[halo: halo + band, k:k + W]
                t = x + s
                ok = act & (vs > 0.5) & (t >= lo) & (t <= hi)
                score = jnp.where(ok, score, -2.0)
                upd = score > best_score
                best_score = jnp.where(upd, score, best_score)
                best_t = jnp.where(upd, t, best_t)
            return best_score, best_t

        init = (jnp.full((band, W), -1.0, jnp.float32),
                jnp.full((band, W), -1, jnp.int32))
        nblocks = jnp.maximum((s_max - s_min + K) // K, 0)
        return jax.lax.fori_loop(0, nblocks, body, init)

    score_b, t_b = jax.lax.map(band_fn, (bL, bR, bvR, bact, blo, bhi))
    best_score = score_b.reshape(Hp, W)[:H]
    best_t = t_b.reshape(Hp, W)[:H]
    matched = best_t >= 0
    x2 = jnp.arange(W, dtype=jnp.int32)[None, :]
    disp = jnp.where(matched, (best_t - x2).astype(jnp.float32),
                     float(NOMATCH))
    return SweepResult(disparity=disp, score=best_score)


def _ncc_sweep_match_tiled(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    validR: jnp.ndarray,
    active: jnp.ndarray,
    bound_lo: jnp.ndarray,
    bound_hi: jnp.ndarray,
    radius: int,
    band: int,
    tile: int,
    sblock: int = 1,
) -> SweepResult:
    """2D-tiled sweep: each (band-rows x tile-cols) tile sweeps only ITS
    OWN shift range.

    Row banding alone cannot bound the work when the disparity VALUE
    varies along x (a band inherits the full row's range); column tiles
    localize that too, so total cost tracks the local disparity spread
    instead of the per-row one.  Identical results to the unbanded sweep:
    global moment maps, real-image halos for the cross box sums, the
    same ascending-candidate argmax.
    """
    H, W = imgL.shape[:2]
    if imgL.ndim == 2:
        imgL, imgR = imgL[..., None], imgR[..., None]
    C = imgL.shape[-1]
    imgL = imgL.astype(jnp.float32) - 128.0
    imgR = imgR.astype(jnp.float32) - 128.0
    r = radius
    momL = ncc_moments(imgL, r)
    momR = ncc_moments(imgR, r)
    n = momL.n

    nb = -(-H // band)
    nt = -(-W // tile)
    Hp, Wp = nb * band, nt * tile

    def pad_hw(a, fill=0.0):
        pads = [(0, Hp - H), (0, Wp - W)] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, pads, constant_values=fill)

    # Per-pixel operands, tiled: (nb*nt, band, tile[, C])
    def tiles_of(a, fill=0.0):
        ap = pad_hw(a, fill)
        a4 = ap.reshape(nb, band, nt, tile, *ap.shape[2:])
        a4 = jnp.moveaxis(a4, 2, 1)             # (nb, nt, band, tile, ...)
        return a4.reshape(nb * nt, band, tile, *ap.shape[2:])

    t_act = tiles_of(active, False)
    t_lo = tiles_of(bound_lo.astype(jnp.int32), 0)
    t_hi = tiles_of(bound_hi.astype(jnp.int32), -1)
    t_muL = tiles_of(momL.mean)
    t_invL = tiles_of(momL.inv_norm, 1.0)

    # Left image with a +-r halo of REAL pixels (zeros outside the image,
    # exactly like the unbanded `shifted` zero padding).
    imgL_h = jnp.pad(pad_hw(imgL), ((r, r), (r, r), (0, 0)))
    rows = (jnp.arange(nb) * band)[:, None] + jnp.arange(band + 2 * r)[None, :]
    cols = (jnp.arange(nt) * tile)[:, None] + jnp.arange(tile + 2 * r)[None, :]
    tl = imgL_h[rows]                       # (nb, band+2r, Wp+2r, C)
    tl = tl[:, :, cols]                     # (nb, band+2r, nt, tile+2r, C)
    t_imgL = jnp.moveaxis(tl, 2, 1).reshape(
        nb * nt, band + 2 * r, tile + 2 * r, C)

    # Right-view operands, padded once; per (tile, shift-block) reads are
    # dynamic slices at x0 + W + s (interior) / with a +-r halo (product).
    K = max(1, sblock)
    imgR_pad = jnp.pad(pad_hw(imgR), ((r, r), (W + r, W + r + K - 1), (0, 0)))
    muR_pad = jnp.pad(pad_hw(momR.mean), ((0, 0), (W, W + K - 1)))
    invR_pad = jnp.pad(pad_hw(momR.inv_norm, 1.0), ((0, 0), (W, W + K - 1)),
                       constant_values=1.0)
    validR_pad = jnp.pad(pad_hw(validR.astype(jnp.float32)),
                         ((0, 0), (W, W + K - 1)))

    row0s = jnp.repeat(jnp.arange(nb, dtype=jnp.int32) * band, nt)
    x0s = jnp.tile(jnp.arange(nt, dtype=jnp.int32) * tile, nb)
    x_in_tile = jnp.arange(tile, dtype=jnp.int32)[None, :]

    def tile_fn(args):
        iL, muL, invL, act, lo, hi, row0, x0 = args
        x_abs = x0 + x_in_tile
        s_lo_px = jnp.where(act, lo - x_abs, jnp.int32(1 << 20))
        s_hi_px = jnp.where(act, hi - x_abs, jnp.int32(-(1 << 20)))
        any_act = act.any()
        s_min = jnp.clip(jnp.where(any_act, s_lo_px.min(), 0),
                         -(W - 1), W - 1)
        s_max = jnp.clip(jnp.where(any_act, s_hi_px.max(), -1),
                         -(W - 1), W - 1)

        def body(i, state):
            s0 = s_min + i * K
            best_score, best_t = state
            Rw = jax.lax.dynamic_slice(
                imgR_pad, (row0, x0 + W + s0, 0),
                (band + 2 * r, tile + 2 * r + K - 1, C))
            muw = jax.lax.dynamic_slice(
                muR_pad, (row0, x0 + W + s0), (band, tile + K - 1))
            invw = jax.lax.dynamic_slice(
                invR_pad, (row0, x0 + W + s0), (band, tile + K - 1))
            vw = jax.lax.dynamic_slice(
                validR_pad, (row0, x0 + W + s0), (band, tile + K - 1))
            for k in range(K):
                s = s0 + k
                Rs = Rw[:, k:k + tile + 2 * r]
                cross = _box_sum((iL * Rs).sum(-1), r)[r:-r, r:-r]
                score = ((cross - n * muL * muw[:, k:k + tile])
                         * invL * invw[:, k:k + tile])
                t = x_abs + s
                ok = (act & (vw[:, k:k + tile] > 0.5)
                      & (t >= lo) & (t <= hi))
                score = jnp.where(ok, score, -2.0)
                upd = score > best_score
                best_score = jnp.where(upd, score, best_score)
                best_t = jnp.where(upd, t, best_t)
            return best_score, best_t

        init = (jnp.full((band, tile), -1.0, jnp.float32),
                jnp.full((band, tile), -1, jnp.int32))
        nblocks = jnp.maximum((s_max - s_min + K) // K, 0)
        return jax.lax.fori_loop(0, nblocks, body, init)

    score_t, t_t = jax.lax.map(
        tile_fn, (t_imgL, t_muL, t_invL, t_act, t_lo, t_hi, row0s, x0s))

    def untile(a):
        a4 = a.reshape(nb, nt, band, tile)
        return jnp.moveaxis(a4, 1, 2).reshape(Hp, Wp)[:H, :W]

    best_score = untile(score_t)
    best_t = untile(t_t)
    matched = best_t >= 0
    x2 = jnp.arange(W, dtype=jnp.int32)[None, :]
    disp = jnp.where(matched, (best_t - x2).astype(jnp.float32),
                     float(NOMATCH))
    return SweepResult(disparity=disp, score=best_score)


def brute_force_match(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    validL: jnp.ndarray,
    validR: jnp.ndarray,
    mL: Margins,
    mR: Margins,
    radius: int,
) -> jnp.ndarray:
    """Level-0 exhaustive scanline match (`CStereoMatching.cpp:170-227`).

    Source pixels: valid mask inside the source view's margins; candidate
    columns: the target view's [XL, XR] margin span.
    """
    H, W = validL.shape
    y = jnp.arange(H, dtype=jnp.int32)[:, None]
    x = jnp.arange(W, dtype=jnp.int32)[None, :]
    active = (validL & (y >= mL.YL) & (y <= mL.YR)
              & (x >= mL.XL) & (x <= mL.XR))
    lo = jnp.broadcast_to(mR.XL, (H, W)).astype(jnp.int32)
    hi = jnp.broadcast_to(mR.XR, (H, W)).astype(jnp.int32)
    return ncc_sweep_match(imgL, imgR, validR, active, lo, hi, radius).disparity


def _forward_fill(values: jnp.ndarray, known: jnp.ndarray, init: jnp.ndarray) -> jnp.ndarray:
    """Per-row forward fill along x: value of the latest known column,
    ``init`` before the first known one.  O(log W) via cummax + gather."""
    W = values.shape[-1]
    idx = jnp.arange(W, dtype=jnp.int32)[None, :]
    last = jax.lax.cummax(jnp.where(known, idx, -1), axis=1)
    filled = jnp.take_along_axis(values, jnp.maximum(last, 0), axis=-1)
    return jnp.where(last >= 0, filled, init)


def guided_search_bounds(
    coarse_disp: jnp.ndarray,
    mL: Margins,
    mR: Margins,
    H: int,
    W: int,
    offset: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel target-column bounds of `HighLevelInitialMatch`
    (`CStereoMatching.cpp:259-288`).

    For pixels whose coarse parent is valid: [x + trunc(2 d + 0.5) -
    offset, x + trunc(2 d + 0.5) + offset] (`:286-287`); for holes, the
    left bound persists from the last valid pixel in the row (the
    reference's running `boundary_L`) and the right bound derives from the
    next valid coarse disparity along the row (`:273-283`, including its
    coarse-index formula `i + trunc(2 d) + offset + 1`).  Both fills are
    O(log W) scans.
    """
    Hc, Wc = coarse_disp.shape
    y = jnp.arange(H, dtype=jnp.int32)[:, None]
    x = jnp.arange(W, dtype=jnp.int32)[None, :]

    # Coarse parent lookup: cy = (y+1)//2, cx = (x+1)//2
    # (`CStereoMatching.cpp:259,267`), clamped in-range (the reference
    # reads out of bounds for the last row/col; masks make that dead).
    cy = jnp.clip((y + 1) // 2, 0, Hc - 1)
    cx = jnp.clip((x + 1) // 2, 0, Wc - 1)
    s_par = coarse_disp[cy, cx]
    par_valid = s_par != NOMATCH

    XL1 = mR.XL.astype(jnp.int32)
    XR1 = mR.XR.astype(jnp.int32)

    # Valid-parent bounds; trunc() matches C double->int casts.
    d2 = jnp.trunc(s_par * 2.0 + 0.5).astype(jnp.int32)
    lo_v = jnp.maximum(x + d2 - offset, XL1)
    hi_v = jnp.minimum(x + d2 + offset, XR1)

    # Hole right bound: next valid coarse column i > cx in the row gives
    # min(i + trunc(2 d_i) + offset + 1, XR1)  (`:273-283`).
    ci = jnp.arange(Wc, dtype=jnp.int32)[None, :]
    cvalid = coarse_disp != NOMATCH
    nxt_rev = jax.lax.cummax(
        jnp.where(cvalid, Wc - 1 - ci, -1)[:, ::-1], axis=1)[:, ::-1]
    nxt = jnp.where(nxt_rev >= 0, Wc - 1 - nxt_rev, Wc)  # next valid >= ci
    # Strictly after cx: evaluate at cx+1.
    nxt_after = jnp.concatenate(
        [nxt[:, 1:], jnp.full((Hc, 1), Wc, jnp.int32)], axis=-1)
    i_star = nxt_after[cy, cx]  # first valid coarse col strictly after cx
    # Reference scans i in (cx, XR>>1]; cap accordingly.
    i_limit = jnp.minimum((jnp.broadcast_to(mL.XR, (H, W)) >> 1), Wc - 1)
    la_exists = i_star <= i_limit
    d_next = jnp.where(
        la_exists, coarse_disp[cy, jnp.clip(i_star, 0, Wc - 1)], 0.0)
    hi_la = jnp.minimum(
        i_star + jnp.trunc(d_next * 2.0).astype(jnp.int32) + offset + 1, XR1)

    # Running bounds across the row (reference keeps boundary_L/R as row
    # state, `:260-261`): forward fills with margin inits.  The row scan
    # starts at XL (`:262`), so columns left of the margin must not seed
    # the fill.
    in_row = x >= mL.XL
    lo = _forward_fill(jnp.where(par_valid, lo_v, 0), par_valid & in_row,
                       jnp.broadcast_to(XL1, (H, W)))
    hi_known = (par_valid | la_exists) & in_row
    hi_candidate = jnp.where(par_valid, hi_v, hi_la)
    hi = _forward_fill(hi_candidate, hi_known,
                       jnp.broadcast_to(XR1, (H, W)))
    return lo, hi


def guided_match(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    validL: jnp.ndarray,
    validR: jnp.ndarray,
    coarse_disp: jnp.ndarray,
    mL: Margins,
    mR: Margins,
    radius: int,
    offset: int = 2,
) -> jnp.ndarray:
    """Coarse-to-fine guided match (`CStereoMatching.cpp:231-308`)."""
    H, W = validL.shape
    y = jnp.arange(H, dtype=jnp.int32)[:, None]
    x = jnp.arange(W, dtype=jnp.int32)[None, :]
    lo, hi = guided_search_bounds(coarse_disp, mL, mR, H, W, offset)
    active = (validL & (y >= mL.YL) & (y <= mL.YR)
              & (x >= mL.XL) & (x <= mL.XR))
    band = 64 if H >= 256 else 0
    tile = 256 if W >= 512 else 0
    return ncc_sweep_match(imgL, imgR, validR, active, lo, hi, radius,
                           band=band, tile=tile).disparity


def rematch(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    validL: jnp.ndarray,
    validR: jnp.ndarray,
    disparity: jnp.ndarray,
    bound_lo: jnp.ndarray,
    bound_hi: jnp.ndarray,
    mL: Margins,
    radius: int,
) -> jnp.ndarray:
    """Hole re-matching within propagated bounds
    (`CStereoMatching.cpp:499-570`): only NOMATCH pixels with a valid mask
    are re-scanned over [BL, BR]; matched pixels keep their disparity."""
    H, W = validL.shape
    y = jnp.arange(H, dtype=jnp.int32)[:, None]
    x = jnp.arange(W, dtype=jnp.int32)[None, :]
    active = (validL & (disparity == NOMATCH)
              & (y >= mL.YL) & (y <= mL.YR)
              & (x >= mL.XL) & (x <= mL.XR))
    band = 64 if H >= 256 else 0
    tile = 256 if W >= 512 else 0
    res = ncc_sweep_match(imgL, imgR, validR, active,
                          bound_lo.astype(jnp.int32),
                          bound_hi.astype(jnp.int32), radius, band=band,
                          tile=tile)
    return jnp.where(active, res.disparity, disparity)

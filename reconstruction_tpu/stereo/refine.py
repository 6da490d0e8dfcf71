"""Iterative subpixel photometric disparity refinement — the Beeler-2010
core loop (`reconstruction/CStereoMatching.cpp:572-680`).

Per iteration, per valid pixel: 3x3 zero-mean NCC costs xi at the three
integer target columns around the current disparity (anchor
t_i = trunc(d - 1.5) + x + i + 1, `:625-628`), mapped to xi = (1 - NCC)/2
(`:629`); discrete argmin with the reference's tie-breaking; parabolic
subpixel estimate d_p with confidence w_p (`:631-650`); blended with an
anisotropic neighbor average d_s using weights
wx = exp(-(|dE-dC| - |dW-dC|)^2), wy likewise (`:664-666`);
d' = (d_p w_p + ws d_s)/(w_p + ws) (`:652-672`).  Jacobi double-buffered
(`:675-679`) => a pure functional update d <- F(d).

Array design: the right-image 3x3 windows never change across
iterations, so the integer-shift NCC cost c3(y, x, s) is precomputed ONCE
as a per-row-rebased local cost volume (each row stores S_CAP shifts
starting at its own base), built from uniform-shift sweeps — no gathers.
Each of the (30 + 30*level) iterations then only gathers three scalars
per pixel from the volume (take_along_axis on the minor axis) plus pure
element-wise math, instead of re-running 3 window correlations per pixel
(the reference recomputes ~27-element dot products every iteration).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.stereo.margins import Margins, inner_box
from reconstruction_tpu.stereo.matching import ncc_moments, _shift_x, _shift_x_pre
from reconstruction_tpu.stereo.ncc import shifted


@partial(jax.jit, static_argnames=("s_cap", "band", "drift"))
def _banded_cost_volume(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    disp: jnp.ndarray,
    s_cap: int,
    band: int,
    drift: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """xi(y, x, j) = (1 - NCC3x3(x, x + base(y) + j)) / 2 for j < s_cap.

    Rows are processed in bands of ``band`` rows; each band gets a scalar
    shift base centered on its own disparity range (a face scanline band
    spans far fewer disparities than the whole image), so each uniform
    shift writes one contiguous slice via dynamic_update_slice — no
    scatter, no gathers.  Out-of-window entries read xi = 0.5 (NCC 0).

    Returns (cv (H, W, s_cap), base (H,)).
    """
    H, W = disp.shape
    dt = disp.dtype
    if imgL.ndim == 2:
        imgL, imgR = imgL[..., None], imgR[..., None]
    C = imgL.shape[-1]
    imgL = imgL.astype(dt) - 128.0
    imgR = imgR.astype(dt) - 128.0

    nb = -(-H // band)
    Hp = nb * band
    # Band row gather with a 1-row halo for the 3x3 y-box.
    padL = jnp.pad(imgL, ((1, Hp - H + 1), (0, 0), (0, 0)))
    padR = jnp.pad(imgR, ((1, Hp - H + 1), (0, 0), (0, 0)))
    starts = jnp.arange(nb) * band
    rows = starts[:, None] + jnp.arange(band + 2)[None, :]  # into padded
    bandL = padL[rows]  # (nb, band+2, W, C)
    bandR = padR[rows]

    dp = jnp.pad(disp, ((0, Hp - H), (0, 0)), constant_values=float(NOMATCH))
    dbands = dp.reshape(nb, band, W)
    big = jnp.asarray(1e9, dt)
    vb = dbands != NOMATCH
    bmin = jnp.min(jnp.where(vb, dbands, big), axis=(1, 2))
    bmax = jnp.max(jnp.where(vb, dbands, -big), axis=(1, 2))
    has = bmin <= bmax
    mid = jnp.where(has, (bmin + bmax) * 0.5, 0.0)
    base_b = jnp.round(mid).astype(jnp.int32) - s_cap // 2      # (nb,)
    # Fill only the band's actual disparity range + drift margin (the
    # refinement nudges d by <= 0.5/iteration toward neighbors, so the
    # default +-16 covers realistic drift); slots outside stay at the
    # neutral 0.5 the same way out-of-window candidates do.
    lo_need = jnp.round(bmin).astype(jnp.int32) - 2 - drift
    hi_need = jnp.round(bmax).astype(jnp.int32) + 3 + drift
    lo_b = jnp.maximum(base_b, lo_need)
    hi_b = jnp.minimum(base_b + s_cap - 1, hi_need)
    lo_b = jnp.where(has, jnp.clip(lo_b, -(W - 1), W - 1), 0)
    hi_b = jnp.where(has, jnp.clip(hi_b, -(W - 1), W - 1), -1)

    def band_fn(args):
        bL, bR, base, lo, hi = args
        momL = ncc_moments(bL, 1)
        momR = ncc_moments(bR, 1)
        n = momL.n
        # pad shifted operands once (not per loop iteration)
        bR_pad = jnp.pad(bR.transpose(2, 0, 1), ((0, 0), (0, 0), (W, W)))
        muR_pad = jnp.pad(momR.mean, ((0, 0), (W, W)))
        invR_pad = jnp.pad(momR.inv_norm, ((0, 0), (W, W)),
                           constant_values=1.0)

        def body(s, cv):
            Rs = _shift_x_pre(bR_pad, s, W, W).transpose(1, 2, 0)
            cross = (bL * Rs).sum(-1)
            bx = cross + shifted(cross, 0, 1) + shifted(cross, 0, -1)
            cross = bx + shifted(bx, 1, 0) + shifted(bx, -1, 0)
            muR_s = _shift_x_pre(muR_pad, s, W, W)
            invR_s = _shift_x_pre(invR_pad, s, W, W)
            ncc = (cross - n * momL.mean * muR_s) * momL.inv_norm * invR_s
            xi = (1.0 - ncc) * 0.5
            xi = xi[1 : band + 1]  # strip halo rows
            slot = s - base
            zero = jnp.zeros((), slot.dtype)
            return jax.lax.dynamic_update_slice(
                cv, xi[:, :, None], (zero, zero, slot))

        cv0 = jnp.full((band, W, s_cap), 0.5, dt)
        return jax.lax.fori_loop(lo, hi + 1, body, cv0)

    cvb = jax.lax.map(band_fn, (bandL, bandR, base_b, lo_b, hi_b))
    cv = cvb.reshape(Hp, W, s_cap)[:H]
    base = jnp.repeat(base_b, band)[:H]
    return cv, base


def resolve_recenter(iterations: int, recenter_every: int,
                     t: int = 6) -> int:
    """Resolve the recenter_every knob: -1 (auto) = ONE mid-run window
    re-extraction, rounded up to a multiple of ``t`` (6: the alignment
    the production outputs were validated with — changing it moves the
    re-extraction sweep and so the refined disparities); 0 = never
    recenter; k > 0 = every k sweeps.  Re-extracting once per run is
    cheap, while k=10 at level-3 iteration counts would triple the
    refine stage."""
    if recenter_every == -1:
        half = -(-max(iterations // 2, 1) // t) * t
        return half if half < iterations else 0
    return recenter_every


@partial(jax.jit, static_argnames=("iterations", "s_cap", "band",
                                   "use_minicv", "drift", "recenter_every"))
def disparity_refine(
    disp: jnp.ndarray,
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    m: Margins,
    iterations: int,
    ws: float = 0.03,
    s_cap: int = 128,
    band: int = 64,
    use_minicv: bool = True,
    drift: int = 16,
    recenter_every: int = 0,
) -> jnp.ndarray:
    """Run the full refinement loop; returns float32 disparity.

    NOMATCH pixels and pixels outside the (margin-inset) interior never
    change (`CStereoMatching.cpp:595,611-613`).

    use_minicv=True (default) runs the cost lookups through a 32-slot
    per-pixel mini volume with branch-free selects instead of
    per-iteration minor-axis gathers.  Semantics verified equal
    (tests/test_stereo_stages.py and the oracle suite run both paths).

    Drift budget: the reference recomputes the 3x3 NCC at the CURRENT
    disparity every iteration (`CStereoMatching.cpp:624-630`), so its
    drift is unbounded.  Here costs live in a precomputed volume whose
    rows are filled over [round(band min)-2-drift, round(band max)+3+drift]
    and, with use_minicv, read through a window covering ~+-12 slots of
    the pixel's anchor.  ``recenter_every=k`` re-extracts the window from
    the banded volume at the current anchors every k iterations, raising
    the usable budget to the banded volume's own ``drift`` margin
    (property-tested against the full-recompute oracle in
    tests/test_stereo_stages.py); -1 = auto (one mid-run re-extraction,
    see resolve_recenter).
    """
    recenter_every = resolve_recenter(iterations, recenter_every)
    H, W = disp.shape
    band = min(band, H)
    # dtype follows the input disparity: float32 in production, float64
    # under jax_enable_x64 for oracle-exact verification runs.
    disp = disp.astype(jnp.promote_types(disp.dtype, jnp.float32))
    cv, base = _banded_cost_volume(imgL, imgR, disp, s_cap, band,
                                   drift=drift)
    inner = inner_box(m, H, W, inset=1)
    ws = jnp.asarray(ws, disp.dtype)
    if use_minicv:
        return _refine_minicv(disp, cv, base, inner, m, iterations, ws,
                              s_cap, recenter_every=recenter_every)

    def one_iter(d, _):
        valid = d != NOMATCH
        dC = d
        dE = shifted(d, 0, 1)
        dW = shifted(d, 0, -1)
        dN = shifted(d, -1, 0)
        dS = shifted(d, 1, 0)
        mode_x = (dE != NOMATCH) & (dW != NOMATCH)
        mode_y = (dS != NOMATCH) & (dN != NOMATCH)

        # Photometric term: xi at the three columns around d
        # (anchor trunc(d - 1.5), `:625`).
        c0 = jnp.trunc(dC - 1.5).astype(jnp.int32)
        s_center = c0 + 2  # disparity of the middle candidate
        j = s_center - base[:, None]
        xs = []
        for i in (-1, 0, 1):
            ji = jnp.clip(j + i, 0, s_cap - 1)
            in_range = (j + i >= 0) & (j + i < s_cap)
            v = jnp.take_along_axis(cv, ji[..., None], axis=2)[..., 0]
            xs.append(jnp.where(in_range, v, 0.5))
        xi0, xi1, xi2 = xs

        # Discrete argmin with reference tie-breaking (`:631-632`).
        idx = (xi0 >= xi1).astype(jnp.int32)
        xi_at = jnp.where(idx == 0, xi0, xi1)
        idx = jnp.where(xi_at > xi2, 2, idx)

        pwp0 = xi1 - xi0
        pdp0 = dC - 0.5
        denom = xi0 + xi2 - 2.0 * xi1
        pwp1 = 0.5 * (xi0 + xi2) - xi1
        safe_denom = jnp.where(denom == 0, 1.0, denom)
        pdp1 = dC + 0.5 * (xi0 - xi2) / safe_denom
        pdp1 = jnp.where(pwp1 == 0, 0.0, pdp1)  # reference quirk `:642-643`
        pwp2 = xi1 - xi2
        pdp2 = dC + 0.5
        pwp = jnp.where(idx == 0, pwp0, jnp.where(idx == 1, pwp1, pwp2))
        pdp = jnp.where(idx == 0, pdp0, jnp.where(idx == 1, pdp1, pdp2))

        # Smoothness term (`:652-672`).
        ex = jnp.exp(-jnp.square(jnp.abs(dE - dC) - jnp.abs(dW - dC)))
        ey = jnp.exp(-jnp.square(jnp.abs(dS - dC) - jnp.abs(dN - dC)))
        wsum = ex + ey
        ds_both = jnp.where(
            wsum == 0,
            (dE + dW + dS + dN) * 0.25,
            (ex * (dE + dW) + ey * (dN + dS)) / (2.0 * jnp.where(wsum == 0, 1.0, wsum)),
        )
        ds = jnp.where(
            mode_x & mode_y, ds_both,
            jnp.where(mode_x, (dE + dW) * 0.5, (dN + dS) * 0.5))

        blended = (pdp * pwp + ws * ds) / (pwp + ws)
        any_mode = mode_x | mode_y
        new_d = jnp.where(any_mode, blended, dC)
        out = jnp.where(valid & inner, new_d, d)
        return out, None

    out, _ = jax.lax.scan(one_iter, disp, None, length=iterations)
    return out


def _window_slots_binshift(cv: jnp.ndarray, j0: jnp.ndarray, mini: int,
                           s_cap: int) -> jnp.ndarray:
    """cvm[y, x, k] = cv[y, x, j0 + k] for k < mini, reading 0.5 wherever
    j0 + k falls outside [0, s_cap) — WITHOUT per-pixel gathers.

    Instead of a per-pixel take_along_axis, the per-pixel start offset is applied as a log2(range) chain
    of conditional slot-axis shifts: each step selects, per pixel,
    between the volume and a statically-shifted copy, halving the
    remaining offset and narrowing the slot extent as the remaining
    shift bound shrinks.  Bitwise-identical to the gather.
    """
    H, W = j0.shape
    cvp = jnp.pad(cv, ((0, 0), (0, 0), (mini, mini)), constant_values=0.5)
    # start into the padded axis; fully-out-of-range windows clip onto the
    # 0.5 pads, matching the gather path's masked fill.
    rem = jnp.clip(j0, -mini, s_cap) + mini     # in [0, s_cap + mini]
    ext = s_cap + 2 * mini
    maxshift = s_cap + mini
    cur = cvp
    for i in reversed(range(int(maxshift).bit_length())):
        step = 1 << i
        new_ext = min(mini + step - 1 if i else mini, ext)
        if step + new_ext <= ext:
            hi = cur[..., step:step + new_ext]
        else:
            hi = jnp.pad(cur[..., step:],
                         ((0, 0), (0, 0), (0, step + new_ext - ext)),
                         constant_values=0.5)
        take = (rem & step) > 0
        cur = jnp.where(take[..., None], hi, cur[..., :new_ext])
        rem = rem & (step - 1)
        ext = new_ext
    return cur


def _refine_minicv(
    disp: jnp.ndarray,
    cv: jnp.ndarray,
    base: jnp.ndarray,
    inner: jnp.ndarray,
    m: Margins,
    iterations: int,
    ws: jnp.ndarray,
    s_cap: int,
    mini: int = 32,
    recenter_every: int = 0,
) -> jnp.ndarray:
    """Gather-free refinement: one 32-slot per-pixel cost window.

    No take_along_axis anywhere: the per-pixel window (centered on the anchor at extraction time) is
    built by fused conditional-shift selects over the banded volume's
    slot axis, and every iteration's three xi lookups are branch-free
    selects over the (mini, H, W) window.  Drift beyond +-(mini/2 - 4)
    of the window anchor reads the neutral 0.5 — consistent with the
    banded volume's own fill margin.  ``recenter_every=k`` re-extracts
    the window at the current anchors every k iterations so sustained
    drift keeps reading real costs (bounded only by the banded volume's
    ``drift`` margin).
    """
    H, W = disp.shape
    center = mini // 2

    def extract_window(d):
        c00 = jnp.trunc(d - 1.5)
        jbig0 = (c00.astype(jnp.int32) + 2) - base[:, None]
        # Gather-free binary-shift extractor (a take_along_axis here
        # measured ~1.8 s at 1920x1280 — ~90% of the whole refine call).
        cvm = _window_slots_binshift(cv, jbig0 - center, mini, s_cap)
        return c00, jnp.moveaxis(cvm, -1, 0)  # (mini, H, W)

    # NOTE: the window MUST flow through the scan carry, not the closure:
    # lax.scan caches the traced body jaxpr by function identity, so a
    # closure-captured (jref, cvm) from the first chunk would silently be
    # reused by every later chunk, disabling recentering (caught by
    # tests/test_stereo_stages.py::test_refine_multi_iteration_matches_
    # full_recompute_oracle).
    def one_iter(carry, _):
        d, jref, cvm = carry
        valid = d != NOMATCH
        dE = shifted(d, 0, 1)
        dW = shifted(d, 0, -1)
        dN = shifted(d, -1, 0)
        dS = shifted(d, 1, 0)
        mode_x = (dE != NOMATCH) & (dW != NOMATCH)
        mode_y = (dS != NOMATCH) & (dN != NOMATCH)
        c0i = jnp.trunc(d - 1.5)
        j = (c0i - jref).astype(jnp.int32) + center
        xs = []
        for off in (-1, 0, 1):
            jj = j + off
            acc = jnp.full(d.shape, 0.5, d.dtype)
            for k in range(mini):
                acc = jnp.where(jj == k, cvm[k], acc)
            xs.append(acc)
        xi0, xi1, xi2 = xs
        idx2 = (xi0 >= xi1).astype(jnp.int32)
        xi_at = jnp.where(idx2 == 0, xi0, xi1)
        idx2 = jnp.where(xi_at > xi2, 2, idx2)
        denom = xi0 + xi2 - 2.0 * xi1
        pwp1 = 0.5 * (xi0 + xi2) - xi1
        pdp1 = d + 0.5 * (xi0 - xi2) / jnp.where(denom == 0, 1.0, denom)
        pdp1 = jnp.where(pwp1 == 0, 0.0, pdp1)
        pwp = jnp.where(idx2 == 0, xi1 - xi0,
                        jnp.where(idx2 == 1, pwp1, xi1 - xi2))
        pdp = jnp.where(idx2 == 0, d - 0.5,
                        jnp.where(idx2 == 1, pdp1, d + 0.5))
        ex = jnp.exp(-jnp.square(jnp.abs(dE - d) - jnp.abs(dW - d)))
        ey = jnp.exp(-jnp.square(jnp.abs(dS - d) - jnp.abs(dN - d)))
        wsum = ex + ey
        ds_both = jnp.where(
            wsum == 0, (dE + dW + dS + dN) * 0.25,
            (ex * (dE + dW) + ey * (dN + dS))
            / (2.0 * jnp.where(wsum == 0, 1.0, wsum)))
        dsv = jnp.where(mode_x & mode_y, ds_both,
                        jnp.where(mode_x, (dE + dW) * 0.5,
                                  (dN + dS) * 0.5))
        blended = (pdp * pwp + ws * dsv) / (pwp + ws)
        new_d = jnp.where(mode_x | mode_y, blended, d)
        return (jnp.where(valid & inner, new_d, d), jref, cvm), None

    d = disp
    jref, cvm = extract_window(d)
    chunk = recenter_every if recenter_every > 0 else iterations
    done = 0
    while done < iterations:
        if done > 0:
            jref, cvm = extract_window(d)
        n = min(chunk, iterations - done)
        (d, _, _), _ = jax.lax.scan(one_iter, (d, jref, cvm), None, length=n)
        done += n
    return d

"""Disparity constraint passes.

Replaces the reference's post-match filters (`CStereoMatching.cpp:310-497,
763-942`) with jit-pure grid ops:

  * smoothness: vectorized 8-neighbor link/violation counting (`:370-448`)
  * ordering: per-scanline greedy crossing removal, batched as a
    vmapped while-loop over row chunks (`:310-368`)
  * uniqueness: gather-based consistency test; the reference's in-place
    left-to-right kill cascade (`p[x-1]` already killed this pass, `:492`)
    is reproduced EXACTLY via an associative boolean scan (`:450-497`)
  * masked median: sort-based, reproducing the reference's actual
    2-column x 3-row window (`:792`) (`:763-815`)
  * disparity-bound propagation: the reference's four sequential
    directional sweeps (`:817-942`) become O(log n) associative scans over
    the (shift, bound) max-plus/min-plus semiring

Deviations from reference (intended-semantics fixes of out-of-channel
writes, each noted inline): the SE link-count aliasing bug
(`CStereoMatching.cpp:423` writes `qup[x]` instead of `qup[2x]`) and the
boundary clamp typo at the row's first pixel (`:938-939` assigns
`bl_src_[XL]` where `br` was meant).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.stereo.margins import Margins, inner_box
from reconstruction_tpu.stereo.ncc import shifted

_BIG = np.float32(1e9)  # plain numpy: no backend init at import


# ---------------------------------------------------------------------------
# Smoothness
# ---------------------------------------------------------------------------

@jax.jit
def smoothness_constraint(disp: jnp.ndarray, m: Margins) -> jnp.ndarray:
    """Kill pixels with no valid neighbors or with disparity jumps >1 to
    more than half of them (`CStereoMatching.cpp:370-448`).

    links(p)      = #{valid 8-neighbors of p}
    violations(p) = #{valid 8-neighbors q : |d(p) - d(q)| > 1}
    kill where links == 0 or 2*violations > links.
    """
    H, W = disp.shape
    box = inner_box(m, H, W)
    valid = (disp != NOMATCH) & box
    dmask = jnp.where(valid, disp, jnp.float32(NOMATCH))

    links = jnp.zeros(disp.shape, jnp.int32)
    viol = jnp.zeros(disp.shape, jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = shifted(dmask, dy, dx)
            nb_valid = shifted(valid.astype(jnp.int32), dy, dx) > 0
            links = links + nb_valid
            viol = viol + (nb_valid & (jnp.abs(disp - nb) > 1)).astype(jnp.int32)
    kill = box & ((links == 0) | (2 * viol > links))
    return jnp.where(kill, jnp.float32(NOMATCH), disp)


# ---------------------------------------------------------------------------
# Ordering
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("row_chunk",))
def ordering_constraint(disp: jnp.ndarray, m: Margins,
                        row_chunk: int = 32) -> jnp.ndarray:
    """Greedy epipolar-order enforcement (`CStereoMatching.cpp:310-368`).

    Two matches (x_i -> t_i), (x_j -> t_j) on a scanline "cross" when their
    target order inverts their source order.  The reference repeatedly
    deletes the point with the most crossings until none remain; the
    deletion ORDER matters, so the greedy loop is kept — but with O(W)
    state: the crossing MATRIX is never stored.  The initial per-point
    crossing counts come from one chunked O(W^2) pass; each kill
    recomputes only the killed point's crossing column on the fly from
    the static predicate and the live mask (the reference instead
    materializes and rewrites an O(W^2) arma matrix per row,
    `CStereoMatching.cpp:337-362`).
    """
    H, W = disp.shape
    box = inner_box(m, H, W)
    dm = jnp.where(box, disp, jnp.float32(NOMATCH))

    xs = jnp.arange(W, dtype=jnp.float32)

    def row_init(d_row):
        valid = d_row != NOMATCH
        t = d_row + xs
        # crossing(i,j): (x_j<x_i & t_j>t_i) | (x_j>x_i & t_j<t_i)
        less = xs[:, None] > xs[None, :]          # x_j < x_i  (j cols)
        tj_gt_ti = t[None, :] > t[:, None]
        cross = ((less & tj_gt_ti)
                 | ((xs[None, :] > xs[:, None]) & (t[None, :] < t[:, None])))
        cross = cross & valid[:, None] & valid[None, :]
        return cross.sum(axis=1).astype(jnp.int32)

    def row_fn(d_row, cnt):
        valid0 = d_row != NOMATCH
        t = d_row + xs

        def cond(state):
            _, _, cnt = state
            return cnt.max() > 0

        def body(state):
            d_row, alive, cnt = state
            k = jnp.argmax(cnt)
            xk = xs[k]
            tk = t[k]
            col = (((xs < xk) & (t > tk)) | ((xs > xk) & (t < tk))) & alive
            d_row = d_row.at[k].set(jnp.float32(NOMATCH))
            alive = alive.at[k].set(False)
            cnt = cnt - col.astype(jnp.int32)
            cnt = cnt.at[k].set(0)
            return d_row, alive, cnt

        d_out, _, _ = jax.lax.while_loop(cond, body, (d_row, valid0, cnt))
        return d_out

    pad_rows = (-H) % row_chunk
    dp = jnp.pad(dm, ((0, pad_rows), (0, 0)), constant_values=float(NOMATCH))
    chunks = dp.reshape(-1, row_chunk, W)
    cnt0 = jax.lax.map(jax.vmap(row_init), chunks)
    out = jax.vmap(row_fn)(chunks.reshape(-1, W), cnt0.reshape(-1, W))
    out = out.reshape(-1, W)[:H]
    return jnp.where(box, out, disp)


# ---------------------------------------------------------------------------
# Uniqueness
# ---------------------------------------------------------------------------

def _q_lookup_banded(q: jnp.ndarray, bL: jnp.ndarray, active: jnp.ndarray,
                     band: int = 64) -> Tuple[jnp.ndarray, ...]:
    """qv_k[y, x] = q[y, clip(bL + k, 0, W-1)] for k in {0, 1, 2}, computed
    WITHOUT minor-axis gathers: rows are banded and each band sweeps only its own range of
    shifts s = clip(bL+k) - x, selecting from uniformly shifted copies of
    q.  Values at ~active pixels are arbitrary (0)."""
    H, W = q.shape
    band = min(band, H)
    nb = -(-H // band)
    Hp = nb * band
    x = jnp.arange(W, dtype=jnp.int32)[None, :]
    sentinel_lo = jnp.int32(1 << 20)
    sentinel_hi = jnp.int32(-(1 << 20))

    cols = [jnp.clip(bL + k, 0, W - 1) for k in range(3)]
    deltas = [jnp.where(active, c - x, sentinel_lo) for c in cols]
    d_lo = jnp.minimum(jnp.minimum(
        jnp.where(active, cols[0] - x, sentinel_lo),
        jnp.where(active, cols[1] - x, sentinel_lo)),
        jnp.where(active, cols[2] - x, sentinel_lo))
    d_hi = jnp.maximum(jnp.maximum(
        jnp.where(active, cols[0] - x, sentinel_hi),
        jnp.where(active, cols[1] - x, sentinel_hi)),
        jnp.where(active, cols[2] - x, sentinel_hi))

    def pad_rows(a, fill=0.0):
        return jnp.pad(a, [(0, Hp - H)] + [(0, 0)] * (a.ndim - 1),
                       constant_values=fill)

    qb = pad_rows(q).reshape(nb, band, W)
    db = [pad_rows(d, 1 << 20).reshape(nb, band, W) for d in deltas]
    lob = pad_rows(d_lo, 1 << 20).reshape(nb, band, W)
    hib = pad_rows(d_hi, -(1 << 20)).reshape(nb, band, W)

    def band_fn(args):
        qrows, d0, d1, d2, lo, hi = args
        any_act = hi.max() >= lo.min()
        s_min = jnp.clip(jnp.where(any_act, lo.min(), 0), -(W - 1), W - 1)
        s_max = jnp.clip(jnp.where(any_act, hi.max(), -1), -(W - 1), W - 1)
        q_pad = jnp.pad(qrows, ((0, 0), (W, W)))

        def body(s, state):
            v0, v1, v2 = state
            qs = jax.lax.dynamic_slice(q_pad, (0, W + s), (band, W))
            return (jnp.where(d0 == s, qs, v0),
                    jnp.where(d1 == s, qs, v1),
                    jnp.where(d2 == s, qs, v2))

        init = tuple(jnp.zeros((band, W), q.dtype) for _ in range(3))
        return jax.lax.fori_loop(s_min, s_max + 1, body, init)

    v0, v1, v2 = jax.lax.map(band_fn, (qb, *db, lob, hib))
    return tuple(v.reshape(Hp, W)[:H] for v in (v0, v1, v2))


def _uniqueness_pass(p: jnp.ndarray, q: jnp.ndarray,
                     m_src: Margins, m_tgt: Margins) -> jnp.ndarray:
    """One directional pass of `UniquenessContraint_`
    (`CStereoMatching.cpp:463-497`), including the in-row kill cascade."""
    H, W = p.shape
    box = inner_box(m_src, H, W)
    valid = (p != NOMATCH) & box
    x = jnp.arange(W, dtype=jnp.int32)[None, :]

    base = jnp.trunc(p + 0.5).astype(jnp.int32) + x - 1
    bL = jnp.maximum(base, m_tgt.XL.astype(jnp.int32))
    bR = jnp.minimum(bL + 2, m_tgt.XR.astype(jnp.int32))

    qv = _q_lookup_banded(q, bL, valid)

    hit = jnp.zeros(p.shape, bool)
    for k in range(3):
        ok = (bL + k) <= bR
        hit = hit | (ok & valid & (jnp.abs(qv[k] + p) < 2))

    q_mid = qv[1]
    p_east = shifted(p, 0, 1)
    c_east = jnp.abs(q_mid + p_east) >= 2           # uses original p[x+1]
    c_west_orig = jnp.abs(q_mid + shifted(p, 0, -1)) >= 2

    # Cascade: the reference writes kills in place while scanning x
    # ascending, so p[x-1] may already be NOMATCH (which always satisfies
    # the west test).  kill(x) = g(x) & (c_west_orig(x) | kill(x-1)) with
    # g = ~hit & c_east & valid: a linear boolean recurrence solved by an
    # associative scan over (b, m) pairs, b = g & c_west_orig, m = g.
    g = valid & (~hit) & c_east
    b = g & c_west_orig
    mm = g

    def combine(l, r):
        bl_, ml_ = l
        br_, mr_ = r
        return (br_ | (mr_ & bl_), mr_ & ml_)

    kill, _ = jax.lax.associative_scan(combine, (b, mm), axis=1)
    return jnp.where(kill, jnp.float32(NOMATCH), p)


@jax.jit
def uniqueness_constraint(d0: jnp.ndarray, d1: jnp.ndarray,
                          m0: Margins, m1: Margins) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full three-pass driver (`CStereoMatching.cpp:450-461`):
    forward, reverse (using the updated forward map), forward again."""
    d0 = _uniqueness_pass(d0, d1, m0, m1)
    d1 = _uniqueness_pass(d1, d0, m1, m0)
    d0 = _uniqueness_pass(d0, d1, m0, m1)
    return d0, d1


# ---------------------------------------------------------------------------
# Median filter
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("iterations",))
def median_filter(disp: jnp.ndarray, valid_mask: jnp.ndarray, m: Margins,
                  iterations: int = 1) -> jnp.ndarray:
    """Masked median with fill/kill rules (`CStereoMatching.cpp:763-815`).

    The reference's window loop `for (i = x-1; i < x+1)` (`:792`) covers
    TWO columns (x-1, x) by three rows — six candidates including the
    center; that exact window is reproduced.  Median of an even count is
    the truncated mean of the middle two (arma::median on integer vectors).
    Pixels outside mask/margins become NOMATCH (the ping-pong buffer is
    initialized to NOMATCH, `:772`).
    """
    H, W = disp.shape
    box = inner_box(m, H, W)
    compute = valid_mask & box

    offsets = [(dy, dx) for dx in (-1, 0) for dy in (-1, 0, 1)]

    def one_iter(d, _):
        vals = jnp.stack([shifted(d, dy, dx) for dy, dx in offsets])  # (6,H,W)
        ok = vals != NOMATCH
        k = ok.sum(axis=0)
        sortable = jnp.where(ok, vals, _BIG)
        svals = jnp.sort(sortable, axis=0)
        lo = jnp.clip((k - 1) // 2, 0, 5)
        hi = jnp.clip(k // 2, 0, 5)
        # per-pixel rank lookups as 6-way selects (no per-pixel gathers)
        v_lo = svals[0]
        v_hi = svals[0]
        for r in range(1, 6):
            v_lo = jnp.where(lo == r, svals[r], v_lo)
            v_hi = jnp.where(hi == r, svals[r], v_hi)
        med = jnp.trunc((v_lo + v_hi) / 2.0)
        center_valid = d != NOMATCH
        out = jnp.where(
            center_valid,
            jnp.where(k <= 2, jnp.float32(NOMATCH), med),
            jnp.where(k >= 4, med, jnp.float32(NOMATCH)),
        )
        out = jnp.where(compute, out, jnp.float32(NOMATCH))
        return out, None

    out, _ = jax.lax.scan(one_iter, disp, None, length=iterations)
    return out


# ---------------------------------------------------------------------------
# Bound propagation (SetBoundary_smooth)
# ---------------------------------------------------------------------------

def _scan_shift_bound(s: jnp.ndarray, mvals: jnp.ndarray, axis: int,
                      reverse: bool, is_max: bool) -> jnp.ndarray:
    """Prefix-compose f(c) = max/min(c + s, m) along ``axis``.

    Returns the composed function's constant term applied to the identity
    carry, i.e. the carry value INTO each position's successor is
    elementwise f applied in sequence.  Output[i] = (f_i o ... o f_0)(init)
    where init is absorbed because every chain starts with a constant
    element (s = -/+inf at the boundary).
    """

    def combine(a, b):
        s1, m1 = a
        s2, m2 = b
        if is_max:
            return s1 + s2, jnp.maximum(m1 + s2, m2)
        return s1 + s2, jnp.minimum(m1 + s2, m2)

    s_c, m_c = jax.lax.associative_scan(combine, (s, mvals), axis=axis,
                                        reverse=reverse)
    return m_c  # with boundary elements constant, composed m == value


@jax.jit
def propagate_bounds(
    disp: jnp.ndarray,
    valid_mask: jnp.ndarray,
    m_src: Margins,
    m_tgt: Margins,
    max_step: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Admissible target-column intervals [BL, BR] for hole re-matching.

    Reproduces `SetBoundary_smooth` (`CStereoMatching.cpp:817-942`): valid
    disparities seed the bounds; four directional sweeps (down, up,
    left->right, right->left) relax them with per-step decays (vertical
    +-max_step; horizontal -1/+max_step forward, -max_step/+1 backward) and
    mask gaps reset the chains.  Every sweep is an associative scan here
    (O(log n) depth instead of O(n) sequential rows/cols).

    Returns absolute-column (BL, BR) float32 maps; meaningful only at
    mask-valid source pixels (like the reference, which leaves other
    entries in relative units).
    """
    H, W = disp.shape
    box = inner_box(m_src, H, W)
    mask = valid_mask & box
    has_d = mask & (disp != NOMATCH)
    ref = jnp.where(has_d, disp, 0.0)
    MD = float(max_step)
    lo_init = jnp.float32(-10000.0)
    hi_init = jnp.float32(10000.0)

    # --- vertical sweeps (`:838-901`): carry into row y+1 is
    # mask(y) ? max((valid ? ref : c) - MD, lo_init) : lo_init
    def vertical(reverse: bool):
        s_lo = jnp.where(mask & ~has_d, -MD, -_BIG)
        m_lo = jnp.where(has_d, ref - MD, lo_init)
        m_lo = jnp.where(mask, jnp.maximum(m_lo, lo_init), lo_init)
        c_lo = _scan_shift_bound(s_lo, m_lo, axis=0, reverse=reverse,
                                 is_max=True)
        s_hi = jnp.where(mask & ~has_d, MD, _BIG)
        m_hi = jnp.where(has_d, ref + MD, hi_init)
        m_hi = jnp.where(mask, jnp.minimum(m_hi, hi_init), hi_init)
        c_hi = _scan_shift_bound(s_hi, m_hi, axis=0, reverse=reverse,
                                 is_max=False)
        # carry INTO row y is the scan value at the previous row
        if reverse:
            in_lo = jnp.concatenate([c_lo[1:], jnp.full((1, W), lo_init)], 0)
            in_hi = jnp.concatenate([c_hi[1:], jnp.full((1, W), hi_init)], 0)
        else:
            in_lo = jnp.concatenate([jnp.full((1, W), lo_init), c_lo[:-1]], 0)
            in_hi = jnp.concatenate([jnp.full((1, W), hi_init), c_hi[:-1]], 0)
        return in_lo, in_hi

    dn_lo, dn_hi = vertical(False)
    up_lo, up_hi = vertical(True)
    BL = jnp.where(has_d, ref, jnp.maximum(dn_lo, up_lo))
    BR = jnp.where(has_d, ref, jnp.minimum(dn_hi, up_hi))
    # Row YL order quirk: the down sweep pins row YL's valid pixels FIRST,
    # then the up sweep max-writes into row YL (`:872-881` runs after
    # `:842-869`), so valid pixels at YL combine with the upward carry.
    # Every other row is re-pinned by whichever sweep runs second.
    y_idx = jnp.arange(H, dtype=jnp.int32)[:, None]
    at_yl = (y_idx == m_src.YL) & has_d
    BL = jnp.where(at_yl, jnp.maximum(ref, up_lo), BL)
    BR = jnp.where(at_yl, jnp.minimum(ref, up_hi), BR)

    # --- forward horizontal (`:903-916`): bl(x) = mask(x-1) ?
    # max(bl(x-1) - 1, V(x)) : V(x);  br analogous with +MD.
    mask_w = shifted(mask.astype(jnp.float32), 0, -1) > 0.5  # mask at x-1
    s_lo = jnp.where(mask_w, -1.0, -_BIG)
    BL = _scan_shift_bound(s_lo, BL, axis=1, reverse=False, is_max=True)
    s_hi = jnp.where(mask_w, MD, _BIG)
    BR = _scan_shift_bound(s_hi, BR, axis=1, reverse=False, is_max=False)

    # --- backward horizontal with absolute conversion (`:917-940`).
    # Relative carry: inc(x-1) = mask(x) ? max(max(u, XL1-x) - MD, .) with
    # u = max(BL_fwd(x), inc(x)); final BL(x) = max(u + x, XL1).
    x = jnp.arange(W, dtype=jnp.float32)[None, :]
    XL1 = m_tgt.XL.astype(jnp.float32)
    XR1 = m_tgt.XR.astype(jnp.float32)
    s_lo = jnp.where(mask, -MD, -_BIG)
    m_lo = jnp.where(mask, jnp.maximum(BL, XL1 - x) - MD, -_BIG)
    c_lo = _scan_shift_bound(s_lo, m_lo, axis=1, reverse=True, is_max=True)
    inc_lo = jnp.concatenate([c_lo[:, 1:], jnp.full((H, 1), -_BIG)], 1)
    u_lo = jnp.maximum(BL, inc_lo)
    BL_abs = jnp.maximum(u_lo + x, XL1)

    s_hi = jnp.where(mask, 1.0, _BIG)
    m_hi = jnp.where(mask, jnp.minimum(BR, XR1 - x) + 1.0, _BIG)
    c_hi = _scan_shift_bound(s_hi, m_hi, axis=1, reverse=True, is_max=False)
    inc_hi = jnp.concatenate([c_hi[:, 1:], jnp.full((H, 1), _BIG)], 1)
    u_hi = jnp.minimum(BR, inc_hi)
    BR_abs = jnp.minimum(u_hi + x, XR1)

    return BL_abs, BR_abs

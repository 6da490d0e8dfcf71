"""Sequential NumPy oracle of the reference stereo-stage semantics.

Each function is a direct, *sequential* expression of the behavior
documented in SURVEY.md / the stage docstrings (with `file:line` citations
into the reference), used to property-test the vectorized array
implementations.  Written for clarity, not speed: plain loops, one pixel
at a time, mirroring the C++ control flow including in-place update order.

Where the framework intentionally deviates from reference bugs (SE
link-count aliasing `CStereoMatching.cpp:423`, the XL clamp typo
`:938-939`, see constraints.py docstring), this oracle implements the
*intended* semantics the framework targets.
"""

import numpy as np

NOMATCH = -10000.0


def window_vec(img, y, x, radius):
    """Zero-mean window vector + norm (`CManageData.cpp:81-90`), zero
    padding outside the image."""
    H, W = img.shape[:2]
    vals = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            yy, xx = y + dy, x + dx
            if 0 <= yy < H and 0 <= xx < W:
                v = img[yy, xx]
            else:
                v = np.zeros(img.shape[2]) if img.ndim == 3 else 0.0
            vals.append(np.atleast_1d(v))
    u = np.concatenate(vals).astype(np.float64)
    u -= u.mean()
    n = np.linalg.norm(u)
    return u, (1.0 if n == 0 else n)


def ncc(imgL, imgR, y, x, t, radius):
    uL, nL = window_vec(imgL, y, x, radius)
    uR, nR = window_vec(imgR, y, t, radius)
    return float(uL @ uR / (nL * nR))


def find_margin(valid, radius):
    H, W = valid.shape
    YL, YR = H - 1 - radius, radius
    XL, XR = W - 1 - radius, radius
    for y in range(radius, H - radius):
        flag = False
        for x in range(radius, W - radius):
            if valid[y, x]:
                XL, XR = min(XL, x), max(XR, x)
                flag = True
        if flag:
            YL, YR = min(YL, y), max(YR, y)
    return YL, YR, XL, XR


def brute_match(imgL, imgR, validL, validR, mL, mR, radius):
    """`LowestLevelInitialMatch` (`CStereoMatching.cpp:170-227`)."""
    H, W = validL.shape
    YL, YR, XL, XR = mL
    _, _, XL1, XR1 = mR
    disp = np.full((H, W), NOMATCH)
    for y in range(YL, YR + 1):
        for x in range(XL, XR + 1):
            if not validL[y, x]:
                continue
            best, best_t = -1.0, -1
            for t in range(XL1, XR1 + 1):
                if not validR[y, t]:
                    continue
                v = ncc(imgL, imgR, y, x, t, radius)
                if v > best:
                    best, best_t = v, t
            if best_t != -1:
                disp[y, x] = best_t - x
    return disp


def guided_bounds(coarse, validL, mL, mR, offset, H, W):
    """Search bounds of `HighLevelInitialMatch` (`CStereoMatching.cpp:
    259-288`), returned per pixel for comparison."""
    YL, YR, XL, XR = mL
    _, _, XL1, XR1 = mR
    Hc, Wc = coarse.shape
    lo = np.zeros((H, W), np.int64)
    hi = np.zeros((H, W), np.int64)
    for y in range(YL, YR + 1):
        cy = min((y + 1) // 2, Hc - 1)
        bl, br = XL1, XR1
        for x in range(XL, XR + 1):
            cx = min((x + 1) // 2, Wc - 1)
            s = coarse[cy, cx]
            if s == NOMATCH:
                for i in range(cx + 1, (XR >> 1) + 1):
                    if i >= Wc:
                        break
                    if coarse[cy, i] != NOMATCH:
                        br = min(i + int(coarse[cy, i] * 2) + offset + 1, XR1)
                        break
            else:
                d2 = int(s * 2 + 0.5) if s * 2 + 0.5 >= 0 else -int(-(s * 2 + 0.5))
                d2 = int(np.trunc(s * 2 + 0.5))
                bl = max(x + d2 - offset, XL1)
                br = min(x + d2 + offset, XR1)
            lo[y, x], hi[y, x] = bl, br
    return lo, hi


def smoothness(disp, m):
    """Intended symmetric semantics of `SmoothConstraint`
    (`CStereoMatching.cpp:370-448`)."""
    H, W = disp.shape
    YL, YR, XL, XR = m
    out = disp.copy()
    for y in range(YL, YR + 1):
        for x in range(XL, XR + 1):
            links = viol = 0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == 0 and dx == 0:
                        continue
                    yy, xx = y + dy, x + dx
                    if not (0 <= yy < H and 0 <= xx < W):
                        continue
                    if disp[y, x] == NOMATCH or disp[yy, xx] == NOMATCH:
                        continue
                    links += 1
                    if abs(disp[y, x] - disp[yy, xx]) > 1:
                        viol += 1
            if links == 0 or 2 * viol > links:
                out[y, x] = NOMATCH
    return out


def ordering(disp, m):
    """`OrderConstraint` greedy (`CStereoMatching.cpp:310-368`)."""
    H, W = disp.shape
    YL, YR, XL, XR = m
    out = disp.copy()
    for y in range(YL, YR + 1):
        idxs = [x for x in range(XL, XR + 1) if out[y, x] != NOMATCH]
        t = [out[y, x] + x for x in idxs]
        n = len(idxs)
        A = np.zeros((n, n), np.int64)
        for i in range(n):
            for j in range(i):
                if t[j] > t[i]:
                    A[i, j] = 1
        A = A + A.T
        cnt = A.sum(1)
        while cnt.max(initial=0) > 0:
            k = int(np.argmax(cnt))
            out[y, idxs[k]] = NOMATCH
            cnt = cnt - A[:, k]
            cnt[k] = 0
            A[k, :] = 0
            A[:, k] = 0
    return out


def uniqueness_pass(p, q, m_src, m_tgt):
    """One pass of `UniquenessContraint_` (`CStereoMatching.cpp:463-497`)
    including the sequential in-place kill cascade."""
    H, W = p.shape
    YL, YR, XL, XR = m_src
    _, _, XL1, XR1 = m_tgt
    p = p.copy()
    for y in range(YL, YR + 1):
        for x in range(XL, XR + 1):
            if p[y, x] == NOMATCH:
                continue
            bL = max(int(np.trunc(p[y, x] + 0.5)) + x - 1, XL1)
            bR = min(bL + 2, XR1)
            hit = False
            for i in range(bL, bR + 1):
                if abs(q[y, min(i, W - 1)] + p[y, x]) < 2:
                    hit = True
                    break
            if not hit:
                qm = q[y, min(bL + 1, W - 1)]
                pw = p[y, x - 1] if x - 1 >= 0 else NOMATCH
                pe = p[y, x + 1] if x + 1 < W else NOMATCH
                if abs(qm + pw) >= 2 and abs(qm + pe) >= 2:
                    p[y, x] = NOMATCH
    return p


def median6(disp, valid, m):
    """`MedianFilter` with the reference's 2x3 window
    (`CStereoMatching.cpp:763-815`)."""
    H, W = disp.shape
    YL, YR, XL, XR = m
    out = np.full((H, W), NOMATCH)
    for y in range(YL, YR + 1):
        for x in range(XL, XR + 1):
            if not valid[y, x]:
                continue
            vals = []
            for xx in (x - 1, x):
                for yy in (y - 1, y, y + 1):
                    if 0 <= yy < H and 0 <= xx < W and disp[yy, xx] != NOMATCH:
                        vals.append(disp[yy, xx])
            k = len(vals)
            vals.sort()
            med = None
            if k:
                lo, hi = vals[(k - 1) // 2], vals[k // 2]
                med = np.trunc((lo + hi) / 2.0)
            if disp[y, x] == NOMATCH:
                out[y, x] = med if k >= 4 else NOMATCH
            else:
                out[y, x] = NOMATCH if k <= 2 else med
    return out


def set_boundary_smooth(disp, mask, m_src, m_tgt, MD=2):
    """`SetBoundary_smooth` (`CStereoMatching.cpp:817-942`), with the
    intended clamp at the row's first pixel."""
    H, W = disp.shape
    YL, YR, XL, XR = m_src
    _, _, XL1, XR1 = m_tgt
    BL = np.full((H, W), -10000.0)
    BR = np.full((H, W), 10000.0)
    # down
    for y in range(YL, YR):
        for x in range(XL, XR + 1):
            if not mask[y, x]:
                continue
            rv = disp[y, x]
            if rv == NOMATCH:
                BL[y + 1, x] = max(BL[y, x] - MD, BL[y + 1, x])
                BR[y + 1, x] = min(BR[y, x] + MD, BR[y + 1, x])
            else:
                BL[y, x] = rv
                BR[y, x] = rv
                BL[y + 1, x] = max(rv - MD, BL[y + 1, x])
                BR[y + 1, x] = min(rv + MD, BR[y + 1, x])
    # up
    for y in range(YR, YL, -1):
        for x in range(XL, XR + 1):
            if not mask[y, x]:
                continue
            rv = disp[y, x]
            if rv == NOMATCH:
                BL[y - 1, x] = max(BL[y, x] - MD, BL[y - 1, x])
                BR[y - 1, x] = min(BR[y, x] + MD, BR[y - 1, x])
            else:
                BL[y, x] = rv
                BR[y, x] = rv
                BL[y - 1, x] = max(rv - MD, BL[y - 1, x])
                BR[y - 1, x] = min(rv + MD, BR[y - 1, x])
    # left -> right
    for y in range(YL, YR + 1):
        for x in range(XL, XR):
            if mask[y, x]:
                BL[y, x + 1] = max(BL[y, x] - 1, BL[y, x + 1])
                BR[y, x + 1] = min(BR[y, x] + MD, BR[y, x + 1])
        # right -> left with absolute conversion
        for x in range(XR, XL, -1):
            if mask[y, x]:
                BL[y, x] += x
                BR[y, x] += x
                BL[y, x] = max(BL[y, x], XL1)
                BR[y, x] = min(BR[y, x], XR1)
                BL[y, x - 1] = max(BL[y, x] - x - MD, BL[y, x - 1])
                BR[y, x - 1] = min(BR[y, x] - x + 1, BR[y, x - 1])
        if mask[y, XL]:
            BL[y, XL] += XL
            BR[y, XL] += XL
            BL[y, XL] = max(BL[y, XL], XL1)
            BR[y, XL] = min(BR[y, XL], XR1)
    return BL, BR


def refine_iteration(disp, imgL, imgR, m, ws):
    """One Jacobi sweep of `DisparityRefine` (`CStereoMatching.cpp:590-678`)."""
    H, W = disp.shape
    YL, YR, XL, XR = m
    out = disp.copy()
    for y in range(YL + 1, YR):
        for x in range(XL + 1, XR):
            dC = disp[y, x]
            if dC == NOMATCH:
                continue
            dE, dW_ = disp[y, x + 1], disp[y, x - 1]
            dN, dS = disp[y - 1, x], disp[y + 1, x]
            mode = int(dE != NOMATCH and dW_ != NOMATCH) + 2 * int(
                dS != NOMATCH and dN != NOMATCH)
            pdp = pwp = 0.0
            if mode != 0:
                iM = int(np.trunc(dC - 1.5)) + x
                xi = []
                for i in range(3):
                    # right window starts at column iM+i (NOT centered):
                    # centered at iM+i+1
                    xi.append((1 - ncc(imgL, imgR, y, x, iM + i + 1, 1)) / 2)
                idx = 1 if xi[0] >= xi[1] else 0
                if xi[idx] > xi[2]:
                    idx = 2
                if idx == 0:
                    pwp, pdp = xi[1] - xi[0], dC - 0.5
                elif idx == 2:
                    pwp, pdp = xi[1] - xi[2], dC + 0.5
                else:
                    pwp = 0.5 * (xi[0] + xi[2]) - xi[1]
                    denom = xi[0] + xi[2] - 2 * xi[1]
                    pdp = dC + (0.5 * (xi[0] - xi[2]) / denom if denom != 0 else 0.0)
                    if pwp == 0:
                        pdp = 0.0
            if mode == 0:
                out[y, x] = dC
            elif mode == 1:
                out[y, x] = (pdp * pwp + ws * (dE + dW_) / 2) / (pwp + ws)
            elif mode == 2:
                out[y, x] = (pdp * pwp + ws * (dN + dS) / 2) / (pwp + ws)
            else:
                wx = np.exp(-(abs(dE - dC) - abs(dW_ - dC)) ** 2)
                wy = np.exp(-(abs(dS - dC) - abs(dN - dC)) ** 2)
                if wx + wy == 0:
                    ds = (dE + dW_ + dS + dN) / 4
                else:
                    ds = (wx * (dE + dW_) + wy * (dN + dS)) / (2 * (wx + wy))
                out[y, x] = (pdp * pwp + ws * ds) / (pwp + ws)
    return out


def dedup(points, normals, valid, P0, centers, masks0, cap=4):
    """Sequential re-expression of the reference cross-view dedup
    (`CCloudOptimization.cpp:152-346`): per-point best-facing pair
    assignment (`:160-176`), pixel-bucket projection (`:178-193`), and
    per-bucket candidate resolution (`:199-338`), with the framework's
    documented deviations applied (dedup.py docstring):

      * buckets span the full image (reference crops to the mask margin
        box, `:181-186`);
      * best-facing uses a true argmax (reference's FLT_MIN init picks
        pair 0 when every score is negative, `:165`);
      * candidates are ordered near-to-far and one representative -- the
        NEAREST -- is kept per facing-direction run (the reference sorts
        far-to-near and, because its NCC windows are read at the same
        pixel for every candidate (`:254,322`), keeps the first
        mask-eligible one; its last run also always drops the final
        (nearest) candidate, `:303-338`);
      * at most ``cap`` candidates per bucket are examined (reference:
        unbounded).

    Returns the boolean keep mask.
    """
    npair, H, W = masks0.shape
    N = len(points)
    keep = np.zeros(N, bool)
    buckets = {}
    pair_of = np.zeros(N, np.int64)
    facing_of = np.zeros(N, bool)
    dist_of = np.zeros(N, np.float64)
    for i in range(N):
        if not valid[i]:
            continue
        # Best-facing pair (`:160-176`).
        best, pj = -np.inf, 0
        for j in range(npair):
            d = centers[j] - points[i]
            s = float(normals[i] @ d) / max(float(np.linalg.norm(d)), 1e-9)
            if s > best:
                best, pj = s, j
        pair_of[i] = pj
        # Facing flag: normal points toward the camera (`:273-281`
        # computes direct = n.(p - C) < 0, i.e. the same sign test).
        facing_of[i] = best > 0
        dist_of[i] = float(np.linalg.norm(centers[pj] - points[i]))
        # Project into the pair's cam0 (`:178-186`).
        ph = P0[pj] @ np.append(points[i], 1.0)
        z = ph[2]
        if z <= 0:
            continue
        u = int(np.round(ph[0] / z))
        v = int(np.round(ph[1] / z))
        if not (0 <= u < W and 0 <= v < H):
            continue
        if masks0[pj, v, u] <= 0.5:
            continue
        buckets.setdefault((pj, v, u), []).append(i)
    for cands in buckets.values():
        # Near-to-far; ties broken by insertion (point-index) order.
        cands = sorted(cands, key=lambda i: dist_of[i])
        for rank, i in enumerate(cands):
            if rank == 0:
                keep[i] = True
            elif rank < cap and facing_of[i] != facing_of[cands[rank - 1]]:
                keep[i] = True
    return keep & valid


def refine_full(disp, imgL, imgR, m, ws, iterations):
    """The complete reference refinement loop (`CStereoMatching.cpp:
    590-679`): every iteration recomputes the 3x3 NCC at the CURRENT
    disparity (`:624-630`), so drift is unbounded — this is the oracle
    the precomputed-volume implementation must match for as long as the
    realized drift stays inside its filled cost window."""
    out = np.asarray(disp, np.float64).copy()
    for _ in range(iterations):
        out = refine_iteration(out, imgL, imgR, m, ws)
    return out


def dedup_ncc(points, normals, valid, P0, P1, centers, masks0,
              images0, images1, cap=4, radius=2):
    """INTENDED-semantics cross-view dedup: like ``dedup`` but same-facing
    duplicate runs are resolved by NCC between the bucket pixel's window
    in the pair's cam0 image and each candidate's PROJECTED-position
    window in cam1 (`CCloudOptimization.cpp:240-267,303-331`; the
    reference reads BOTH windows at the cam0 pixel — `:254,322` — which
    degenerates its own scoring to first-eligible-wins, so this oracle
    implements what the code intends rather than what it does).
    Candidates whose cam1 projection is out of mask are ineligible; if no
    candidate in a run is eligible the run's nearest survives (matching
    ``dedup``'s representative so the two variants differ only where the
    NCC actually votes)."""
    npair, H, W = masks0.shape
    N = len(points)
    keep = np.zeros(N, bool)
    buckets = {}
    facing_of = np.zeros(N, bool)
    dist_of = np.zeros(N, np.float64)
    px_of = {}
    for i in range(N):
        if not valid[i]:
            continue
        best, pj = -np.inf, 0
        for j in range(npair):
            d = centers[j] - points[i]
            s = float(normals[i] @ d) / max(float(np.linalg.norm(d)), 1e-9)
            if s > best:
                best, pj = s, j
        facing_of[i] = best > 0
        dist_of[i] = float(np.linalg.norm(centers[pj] - points[i]))
        ph = P0[pj] @ np.append(points[i], 1.0)
        if ph[2] <= 0:
            continue
        u = int(np.round(ph[0] / ph[2]))
        v = int(np.round(ph[1] / ph[2]))
        if not (0 <= u < W and 0 <= v < H):
            continue
        if masks0[pj, v, u] <= 0.5:
            continue
        px_of[i] = (pj, v, u)
        buckets.setdefault((pj, v, u), []).append(i)

    def cam1_window_score(pj, v, u, i):
        """NCC of cam0 window at the bucket pixel vs cam1 window at the
        candidate's projected position; None if out of mask/image."""
        ph = P1[pj] @ np.append(points[i], 1.0)
        if ph[2] <= 0:
            return None
        u1 = int(np.round(ph[0] / ph[2]))
        v1 = int(np.round(ph[1] / ph[2]))
        if not (0 <= u1 < W and 0 <= v1 < H):
            return None
        uL, nL = window_vec(images0[pj], v, u, radius)
        uR, nR = window_vec(images1[pj], v1, u1, radius)
        return float(uL @ uR / (nL * nR))

    for (pj, v, u), cands in buckets.items():
        cands = sorted(cands, key=lambda i: dist_of[i])
        runs = []
        for rank, i in enumerate(cands[:cap]):
            if not runs or facing_of[i] != facing_of[runs[-1][-1]]:
                runs.append([i])
            else:
                runs[-1].append(i)
        for run in runs:
            if len(run) == 1:
                keep[run[0]] = True
                continue
            best_i, best_s = None, -np.inf
            for i in run:
                s = cam1_window_score(pj, v, u, i)
                if s is not None and s > best_s:
                    best_i, best_s = i, s
            keep[best_i if best_i is not None else run[0]] = True
    return keep & valid

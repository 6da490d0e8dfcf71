"""Bundle adjustment with Schur-complement reduction.

New first-class capability (absent in the reference, which reads
calibration from file, `CManageData.cpp:45-64`; required by the
BASELINE.json north star: "pose-graph + bundle-adjustment stage ...
distributed bundle adjustment via Schur-complement reduction of
camera/point blocks over psum/all-gather collectives").

Formulation:
  * cameras: fixed K; pose perturbation (omega, tau) about a base [R|t]
    (left-multiplied SE(3) increment), 6 DoF per camera.
  * points: 3 DoF each.
  * residuals: Huber-weighted reprojection errors.
  * Gauss-Newton step: per-observation Jacobians from forward-mode
    autodiff (vmapped), assembled into 6x6 camera blocks H_cc, 3x3 point
    blocks H_pp and 6x3 couplings; the reduced camera system
      S = H_cc - sum_j H_cp,j H_pp,j^-1 H_pc,j
    is a small dense SPD matrix (6C x 6C) solved by Cholesky; point
    updates back-substitute in closed form (batched 3x3 solves).

Observations are stored grouped by point, so sharding the point axis
makes H_pp shard-local and S a pure psum reduction — the distributed
path (parallel/distributed_ba.py) reuses the same block assembly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class BAProblem(NamedTuple):
    """Observations grouped by point (padded).

    K: (C, 3, 3) intrinsics.  Rt0: (C, 3, 4) base extrinsics.
    points0: (M, 3) initial points.
    obs_uv: (M, O, 2) observed pixels (O = max obs per point).
    obs_cam: (M, O) camera index per observation.
    obs_ok: (M, O) validity.
    """

    K: jnp.ndarray
    Rt0: jnp.ndarray
    points0: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_cam: jnp.ndarray
    obs_ok: jnp.ndarray


def _rodrigues(w: jnp.ndarray) -> jnp.ndarray:
    """exp of so(3), autodiff-safe at w = 0 (poses start there): uses the
    unnormalized skew matrix with smooth sinc coefficients — no division
    by ||w|| whose derivative is undefined at the origin."""
    # eps sized so denominator^2 terms in the autodiff tangents stay
    # representable in f32 (1e-24 underflows when squared).
    th2 = jnp.dot(w, w)
    th = jnp.sqrt(th2 + 1e-12)
    A = jnp.sin(th) / th
    B = (1.0 - jnp.cos(th)) / (th2 + 1e-12)
    W = jnp.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return jnp.eye(3) + A * W + B * (W @ W)


def _project(K, Rt0, pose6, X):
    """Project point X through camera with pose perturbation pose6.

    Fully elementwise: every matrix action is unrolled to scalar
    components, because under vmap the 3x3 matmul form lowers to
    batched tiny dot_generals; the unrolled form fuses into plain
    elementwise code.
    The rotation acts via Rodrigues on vectors:
    R(w) v = v + A (w x v) + B (w x (w x v)), same smooth-sinc A/B and
    eps conventions as _rodrigues.
    """
    w0, w1, w2 = pose6[0], pose6[1], pose6[2]
    tau0, tau1, tau2 = pose6[3], pose6[4], pose6[5]
    X0, X1, X2 = X[0], X[1], X[2]
    y0 = Rt0[0, 0] * X0 + Rt0[0, 1] * X1 + Rt0[0, 2] * X2 + Rt0[0, 3]
    y1 = Rt0[1, 0] * X0 + Rt0[1, 1] * X1 + Rt0[1, 2] * X2 + Rt0[1, 3]
    y2 = Rt0[2, 0] * X0 + Rt0[2, 1] * X1 + Rt0[2, 2] * X2 + Rt0[2, 3]
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = jnp.sqrt(th2 + 1e-12)
    A = jnp.sin(th) / th
    B = (1.0 - jnp.cos(th)) / (th2 + 1e-12)
    c0 = w1 * y2 - w2 * y1
    c1 = w2 * y0 - w0 * y2
    c2 = w0 * y1 - w1 * y0
    d0 = w1 * c2 - w2 * c1
    d1 = w2 * c0 - w0 * c2
    d2 = w0 * c1 - w1 * c0
    z0 = y0 + A * c0 + B * d0 + tau0
    z1 = y1 + A * c1 + B * d1 + tau1
    z2 = y2 + A * c2 + B * d2 + tau2
    u = K[0, 0] * z0 + K[0, 1] * z1 + K[0, 2] * z2
    v = K[1, 0] * z0 + K[1, 1] * z1 + K[1, 2] * z2
    s = K[2, 0] * z0 + K[2, 1] * z1 + K[2, 2] * z2
    return jnp.stack([u / s, v / s])


def _residual(K, Rt0, pose6, X, uv):
    return _project(K, Rt0, pose6, X) - uv


# Per-observation Jacobians via forward-mode autodiff — kept as the
# reference implementation the analytic forms are tested against
# (test_ba.test_analytic_jacobians_match_jacfwd); production assembly
# uses _obs_jacobians (jacfwd's 9 batched tangent streams measured
# ~25 ms of the 30 ms ba_step at 512k observations).
_jac_pose = jax.jacfwd(_residual, argnums=2)
_jac_point = jax.jacfwd(_residual, argnums=3)


def _obs_jacobians(K, Rt0, pose6, X, uv):
    """Residual + closed-form Jacobians for one observation.

    Returns (r (2,), Jc (2, 6) d r/d pose6, Jp (2, 3) d r/d X), all
    derived by hand from the elementwise _project chain:
      y = R0 X + t0;  z = R(w) y + tau;  p = K z;  r = p[:2]/p[2] - uv
    with R(w) v = v + A (w x v) + B (w x (w x v)).
      dz/dtau = I;  dz/dX = R(w) R0 (Rodrigues action on R0 columns);
      dz/dw_k = A'_k c + A (e_k x y) + B'_k d + B (e_k x c + w x (e_k x y))
    where A'_k = w_k (cos th - A)/th^2, B'_k = w_k (A - 2B)/th^2 (same
    smoothed-sinc eps conventions as _project, so the forms agree with
    autodiff of the smoothed primal to ~1e-5).
    """
    w0, w1, w2 = pose6[0], pose6[1], pose6[2]
    tau0, tau1, tau2 = pose6[3], pose6[4], pose6[5]
    X0, X1, X2 = X[0], X[1], X[2]
    y0 = Rt0[0, 0] * X0 + Rt0[0, 1] * X1 + Rt0[0, 2] * X2 + Rt0[0, 3]
    y1 = Rt0[1, 0] * X0 + Rt0[1, 1] * X1 + Rt0[1, 2] * X2 + Rt0[1, 3]
    y2 = Rt0[2, 0] * X0 + Rt0[2, 1] * X1 + Rt0[2, 2] * X2 + Rt0[2, 3]
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = jnp.sqrt(th2 + 1e-12)
    A = jnp.sin(th) / th
    B = (1.0 - jnp.cos(th)) / (th2 + 1e-12)
    dA = (jnp.cos(th) - A) / (th2 + 1e-12)   # dA/dw_k = w_k * dA
    dB = (A - 2.0 * B) / (th2 + 1e-12)       # dB/dw_k = w_k * dB

    def cross(a0, a1, a2, b0, b1, b2):
        return (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0)

    def rot(v0, v1, v2):
        """R(w) v, reusing A/B."""
        c0, c1, c2 = cross(w0, w1, w2, v0, v1, v2)
        d0, d1, d2 = cross(w0, w1, w2, c0, c1, c2)
        return (v0 + A * c0 + B * d0, v1 + A * c1 + B * d1,
                v2 + A * c2 + B * d2)

    c0, c1, c2 = cross(w0, w1, w2, y0, y1, y2)
    d0, d1, d2 = cross(w0, w1, w2, c0, c1, c2)
    z0 = y0 + A * c0 + B * d0 + tau0
    z1 = y1 + A * c1 + B * d1 + tau1
    z2 = y2 + A * c2 + B * d2 + tau2
    u = K[0, 0] * z0 + K[0, 1] * z1 + K[0, 2] * z2
    v = K[1, 0] * z0 + K[1, 1] * z1 + K[1, 2] * z2
    s = K[2, 0] * z0 + K[2, 1] * z1 + K[2, 2] * z2
    inv_s = 1.0 / s
    us = u * inv_s
    vs = v * inv_s
    r = jnp.stack([us - uv[0], vs - uv[1]])

    # dr/dz rows (2, 3)
    Ju = [(K[0, j] - us * K[2, j]) * inv_s for j in range(3)]
    Jv = [(K[1, j] - vs * K[2, j]) * inv_s for j in range(3)]

    # dz/dw columns (one per w_k)
    dz_w = []
    for k in range(3):
        e = [0.0, 0.0, 0.0]
        e[k] = 1.0
        ey = cross(e[0], e[1], e[2], y0, y1, y2)       # e_k x y
        ec = cross(e[0], e[1], e[2], c0, c1, c2)       # e_k x c
        wey = cross(w0, w1, w2, *ey)                   # w x (e_k x y)
        wk = (w0, w1, w2)[k]
        dz_w.append(tuple(
            wk * dA * (c0, c1, c2)[j] + A * ey[j]
            + wk * dB * (d0, d1, d2)[j] + B * (ec[j] + wey[j])
            for j in range(3)))

    # dz/dX columns: R(w) applied to R0's columns.
    rx = [rot(Rt0[0, j], Rt0[1, j], Rt0[2, j]) for j in range(3)]

    def proj_rows(cols):
        """(2, len(cols)) projection of dz columns through dr/dz."""
        top = [Ju[0] * col[0] + Ju[1] * col[1] + Ju[2] * col[2]
               for col in cols]
        bot = [Jv[0] * col[0] + Jv[1] * col[1] + Jv[2] * col[2]
               for col in cols]
        return jnp.stack([jnp.stack(top), jnp.stack(bot)])

    eye_cols = [(1.0 + 0.0 * z0, 0.0 * z0, 0.0 * z0),
                (0.0 * z0, 1.0 + 0.0 * z0, 0.0 * z0),
                (0.0 * z0, 0.0 * z0, 1.0 + 0.0 * z0)]
    Jc = jnp.concatenate([proj_rows(dz_w), proj_rows(eye_cols)], axis=1)
    Jp = proj_rows(rx)
    return r, Jc, Jp


def _obs_jac_scalars(K, Rt0, pose6, X, uv):
    """_obs_jacobians flattened to a 20-tuple of scalars
    (r0, r1, Jc[2x6] row-major, Jp[2x3] row-major).  vmapped, each
    output is a clean (N,) vector instead of stacked (N, 2, 6)/(N, 2, 3)
    forms with tiny trailing dims."""
    r, Jc, Jp = _obs_jacobians(K, Rt0, pose6, X, uv)
    out = [r[0], r[1]]
    out += [Jc[a, i] for a in range(2) for i in range(6)]
    out += [Jp[a, i] for a in range(2) for i in range(3)]
    return tuple(out)


def _m3_mul(A, B):
    """Component-wise 3x3 product of row-major 9-tuples of arrays."""
    out = []
    for r in range(3):
        for c in range(3):
            out.append(A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c]
                       + A[3 * r + 2] * B[6 + c])
    return out


def _sym3_inv_comps(h):
    """Inverse of symmetric 3x3 given as (xx, xy, xz, yy, yz, zz)
    component arrays; returns the row-major 9-tuple.  Adjugate/det plus
    two Newton refinements (same accuracy contract as _inv3x3)."""
    a, b, c, e, f, i = h
    A11 = e * i - f * f
    A12 = c * f - b * i
    A13 = b * f - c * e
    A22 = a * i - c * c
    A23 = c * b - a * f
    A33 = a * e - b * b
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / det
    X = [A11 * inv_det, A12 * inv_det, A13 * inv_det,
         A12 * inv_det, A22 * inv_det, A23 * inv_det,
         A13 * inv_det, A23 * inv_det, A33 * inv_det]
    A9 = [a, b, c, b, e, f, c, f, i]
    for _ in range(2):
        AX = _m3_mul(A9, X)
        Y = [2.0 - AX[0], -AX[1], -AX[2],
             -AX[3], 2.0 - AX[4], -AX[5],
             -AX[6], -AX[7], 2.0 - AX[8]]
        X = _m3_mul(X, Y)
    return tuple(X)


def _huber_weight(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    nrm = jnp.linalg.norm(r) + 1e-12
    return jnp.minimum(1.0, delta / nrm)


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det).

    Batched LU (`jnp.linalg.inv`) lowers to loop-heavy code; the
    adjugate is ~50 fused elementwise ops per matrix.  Inputs are the Tikhonov-regularized SPD point blocks,
    so det > 0.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1),
    ], -2)
    X = adj / det[..., None, None]
    # Two Newton refinements X <- X (2I - A X): each doubles the
    # accurate digits, recovering LU-level f32 accuracy on the
    # ill-conditioned depth direction of weak-baseline point blocks for
    # ~4 batched 3x3 matmuls (tests regressed 3x in point recovery on
    # the raw adjugate).
    I2 = 2.0 * jnp.eye(3, dtype=A.dtype)
    for _ in range(2):
        X = X @ (I2 - A @ X)
    return X


def _solve3x3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3x3 solve via the closed-form inverse: (..., 3, 3) x
    (..., 3) -> (..., 3)."""
    return jnp.einsum("...ij,...j->...i", _inv3x3(A), b)


def _gather_obs_params(problem: BAProblem, poses: jnp.ndarray,
                       cam_flat: jnp.ndarray, C: int):
    """Per-observation camera parameters via ONE-HOT MATMUL.

    A (N, C) @ (C, 27) matmul replaces per-element
    `K[cam]`/`Rt0[cam]`/`poses[cam]` gathers and is exact for one-hot
    rows.
    Returns (oh (N, C), K (N,3,3), Rt0 (N,3,4), pose (N,6)).
    """
    oh = jax.nn.one_hot(cam_flat, C, dtype=poses.dtype)         # (N, C)
    pack = jnp.concatenate([problem.K.reshape(C, 9),
                            problem.Rt0.reshape(C, 12),
                            poses], axis=1)                      # (C, 27)
    # Precision HIGHEST: at reduced precision (bf16 or TF32 operand
    # passes) K/poses would be quantized BEFORE the one-hot select — the
    # "exact for one-hot rows" claim only holds at full f32.  The matmul
    # is tiny ((N, C) @ (C, 27)) so the extra passes are free.
    obs = jnp.matmul(oh, pack, precision=jax.lax.Precision.HIGHEST)
    N = cam_flat.shape[0]
    return (oh, obs[:, :9].reshape(N, 3, 3),
            obs[:, 9:21].reshape(N, 3, 4), obs[:, 21:27])


@partial(jax.jit, static_argnames=("num_cameras",))
def ba_blocks(
    problem: BAProblem,
    poses: jnp.ndarray,
    points: jnp.ndarray,
    num_cameras: int,
    huber_delta: float = 2.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, tuple, tuple, jnp.ndarray, jnp.ndarray]:
    """Assemble GN blocks, SoA throughout.

    Returns (S_partial (6C, 6C), b_c (6C,),
             hpp_reg (6-tuple of (M,) upper-tri components, Tikhonov
             regularized), b_p (3-tuple of (M,) components),
             W_t (18, C, M) couplings with e = 6*i_pose + j_point ...
             laid out (i, j)-major, and cost (scalar)).
    The caller psums S_partial / b_c / cost across point shards.

    Layout: component arrays keep every big tensor either
    (N,)/(M,)-shaped, (36|18|6, N)-shaped (row-major stacks feeding
    one-hot matmul reductions), or (6C, M)-shaped for the Schur
    matmuls, instead of intermediates with tiny trailing dims such as
    (M, 3, 3), (N, 2, 6) or (M, C, 6, 3).
    """
    C = num_cameras
    M, O = problem.obs_cam.shape
    N = M * O

    # Flatten observations and gather camera params by one-hot matmul.
    cam = problem.obs_cam.reshape(N)
    ok = problem.obs_ok.reshape(N).astype(poses.dtype)
    uv = problem.obs_uv.reshape(N, 2)
    oh, K_o, Rt_o, pose_o = _gather_obs_params(problem, poses, cam, C)
    X_o = jnp.broadcast_to(points[:, None, :], (M, O, 3)).reshape(N, 3)

    vals = jax.vmap(_obs_jac_scalars)(K_o, Rt_o, pose_o, X_o, uv)
    r = [vals[0], vals[1]]
    Jc = [[vals[2 + a * 6 + i] for i in range(6)] for a in range(2)]
    Jp = [[vals[14 + a * 3 + j] for j in range(3)] for a in range(2)]
    nrm = jnp.sqrt(r[0] * r[0] + r[1] * r[1]) + 1e-12
    w = jnp.minimum(1.0, huber_delta / nrm) * ok
    r = [x * w for x in r]
    Jc = [[x * w for x in row] for row in Jc]
    Jp = [[x * w for x in row] for row in Jp]

    cost = 0.5 * (jnp.sum(r[0] ** 2) + jnp.sum(r[1] ** 2))

    # Point blocks: per-point reduces of (N,) component products.
    po = lambda x: x.reshape(M, O).sum(axis=1)
    lam = 1e-6
    hpp = []
    for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        comp = po(Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j])
        hpp.append(comp + lam if i == j else comp)
    hpp = tuple(hpp)
    b_p = tuple(-po(Jp[0][j] * r[0] + Jp[1][j] * r[1]) for j in range(3))

    # Camera blocks: (36|6, N) row stacks reduced by ONE one-hot matmul.
    # HIGHEST precision: the products feeding these Hessian reductions
    # would otherwise be rounded to bf16/TF32 operands; output is tiny
    # ((36|6) x C) so the extra passes cost nothing.
    hi = jax.lax.Precision.HIGHEST
    Gt = jnp.stack([Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j]
                    for i in range(6) for j in range(6)])     # (36, N)
    Hcc = jnp.matmul(Gt, oh, precision=hi).reshape(6, 6, C).transpose(2, 0, 1)
    gct = jnp.stack([Jc[0][i] * r[0] + Jc[1][i] * r[1]
                     for i in range(6)])                      # (6, N)
    b_c = -jnp.matmul(gct, oh, precision=hi).T                # (C, 6)

    # Couplings W_t[e, c, m] = sum_o He[e, m, o] [cam[m, o] == c], as a
    # fused broadcast-reduce over (18, C, M, O).  It re-reads the He
    # rows once per camera; a per-camera segment sum would not.
    He = jnp.stack([(Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j])
                    .reshape(M, O)
                    for i in range(6) for j in range(3)])      # (18,M,O)
    oh_t = oh.T.reshape(C, M, O)
    W_t = (He[:, None] * oh_t[None]).sum(-1)                   # (18,C,M)

    # Schur reduction: S = blockdiag(Hcc) - sum_k Xk Yk^T with
    # (c, i)-major (6C, M) slabs — three plain matmuls.
    Hinv = _sym3_inv_comps(hpp)                               # 9 x (M,)
    WH_rows = []
    for i in range(6):
        for k in range(3):
            acc = W_t[i * 3 + 0] * Hinv[0 + k][None, :]
            for j in range(1, 3):
                acc = acc + W_t[i * 3 + j] * Hinv[3 * j + k][None, :]
            WH_rows.append(acc)
    WH_t = jnp.stack(WH_rows)                                 # (18, C, M)

    S_red = jnp.zeros((C * 6, C * 6), W_t.dtype)
    b_red = jnp.zeros((C * 6,), W_t.dtype)
    for k in range(3):
        sel = [i * 3 + k for i in range(6)]
        Xk = WH_t[np.asarray(sel)].transpose(1, 0, 2).reshape(C * 6, M)
        Yk = W_t[np.asarray(sel)].transpose(1, 0, 2).reshape(C * 6, M)
        S_red = S_red + jnp.matmul(Xk, Yk.T, precision=hi)
        b_red = b_red + jnp.matmul(Xk, b_p[k], precision=hi)
    S = _blockdiag(Hcc) - S_red
    b = b_c.reshape(C * 6) - b_red
    return S, b, hpp, b_p, W_t, cost


def _blockdiag(blocks: jnp.ndarray) -> jnp.ndarray:
    C = blocks.shape[0]
    out = jnp.zeros((C * 6, C * 6), blocks.dtype)
    for i in range(C):
        out = out.at[i * 6:(i + 1) * 6, i * 6:(i + 1) * 6].set(blocks[i])
    return out


@partial(jax.jit, static_argnames=("num_cameras", "fix_gauge",
                                   "fix_cameras"))
def ba_step(
    problem: BAProblem,
    poses: jnp.ndarray,
    points: jnp.ndarray,
    num_cameras: int,
    damping: float = 1e-3,
    huber_delta: float = 2.0,
    fix_gauge: bool = True,
    fix_cameras: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One Gauss-Newton/LM step.  Returns (poses', points', cost).

    fix_cameras=True freezes all poses (structure-only refinement —
    useful when calibration is trusted, as in the reference rig).

    Gauge: fix_gauge pins camera 0 (6 DoF); the 7th gauge DoF — scale
    about camera 0's center — is unconstrained by reprojection, so
    solutions are defined up to that similarity unless the problem
    carries a metric anchor (known baseline / fix_cameras).
    """
    C = num_cameras
    S, b, hpp, b_p, W_t, cost = ba_blocks(problem, poses, points, C,
                                          huber_delta)
    if fix_cameras:
        hd = tuple(h + (damping if i in (0, 3, 5) else 0.0)
                   for i, h in enumerate(hpp))
        Hinv = _sym3_inv_comps(hd)
        dp = jnp.stack([Hinv[3 * i + 0] * b_p[0] + Hinv[3 * i + 1] * b_p[1]
                        + Hinv[3 * i + 2] * b_p[2] for i in range(3)],
                       axis=1)
        return poses, points + dp, cost
    S = S + damping * jnp.eye(C * 6)
    if fix_gauge:
        # pin camera 0 (gauge freedom): zero its rows/cols, identity diag
        mask = jnp.arange(C * 6) >= 6
        S = jnp.where(mask[:, None] & mask[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(mask, 0.0, 1.0))
        b = jnp.where(mask, b, 0.0)
    dc = jnp.linalg.solve(S, b).reshape(C, 6)

    # Back-substitute points: Hpp dp = b_p - W^T dc (summed over cams),
    # all in component form (W_t is (18, C, M), e = 3*i_pose + j_point).
    rhs = []
    for k in range(3):
        Wk = W_t[np.asarray([i * 3 + k for i in range(6)])]           # (6, C, M)
        rhs.append(b_p[k] - (Wk * dc.T[:, :, None]).sum((0, 1)))
    Hinv = _sym3_inv_comps(hpp)
    dp = jnp.stack([Hinv[3 * i + 0] * rhs[0] + Hinv[3 * i + 1] * rhs[1]
                    + Hinv[3 * i + 2] * rhs[2] for i in range(3)],
                   axis=1)
    return poses + dc, points + dp, cost


@partial(jax.jit, static_argnames=("num_cameras",))
def ba_cost(problem: BAProblem, poses: jnp.ndarray, points: jnp.ndarray,
            num_cameras: int, huber_delta: float = 2.0) -> jnp.ndarray:
    M, O = problem.obs_cam.shape
    N = M * O
    cam = problem.obs_cam.reshape(N)
    ok = problem.obs_ok.reshape(N).astype(poses.dtype)
    uv = problem.obs_uv.reshape(N, 2)
    _, K_o, Rt_o, pose_o = _gather_obs_params(problem, poses, cam,
                                              num_cameras)
    X_o = jnp.broadcast_to(points[:, None, :], (M, O, 3)).reshape(N, 3)
    r = jax.vmap(_residual)(K_o, Rt_o, pose_o, X_o, uv)
    w = jax.vmap(_huber_weight, in_axes=(0, None))(r, huber_delta) * ok
    return 0.5 * jnp.sum((r * w[:, None]) ** 2)


def bundle_adjust(
    problem: BAProblem,
    iterations: int = 10,
    damping: float = 1e-3,
    huber_delta: float = 2.0,
    fix_cameras: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Levenberg-Marquardt driver: adaptive damping with accept/reject.

    Returns (poses (C, 6), points (M, 3), accepted costs)."""
    C = problem.K.shape[0]
    poses = jnp.zeros((C, 6), problem.points0.dtype)
    points = problem.points0
    lam = damping
    cost = float(ba_cost(problem, poses, points, C, huber_delta))
    costs = [cost]
    for _ in range(iterations):
        accepted = False
        for _try in range(6):
            p2, x2, _ = ba_step(problem, poses, points, C, lam, huber_delta,
                                fix_cameras=fix_cameras)
            c2 = float(ba_cost(problem, p2, x2, C, huber_delta))
            if np.isfinite(c2) and c2 < cost:
                poses, points, cost = p2, x2, c2
                lam = max(lam * 0.5, 1e-8)
                accepted = True
                break
            lam *= 10.0
        costs.append(cost)
        if not accepted and lam > 1e8:
            break
    return poses, points, jnp.asarray(costs)


def apply_pose(Rt0: np.ndarray, pose6: np.ndarray) -> np.ndarray:
    """Compose the optimized perturbation with the base extrinsics."""
    from reconstruction_tpu.core.rectify import rodrigues_mat
    R = rodrigues_mat(np.asarray(pose6[:3], np.float64))
    out = np.zeros((3, 4))
    out[:, :3] = R @ np.asarray(Rt0)[:, :3]
    out[:, 3] = R @ np.asarray(Rt0)[:, 3] + np.asarray(pose6[3:])
    return out

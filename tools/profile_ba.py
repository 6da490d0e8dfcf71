"""Stage-level on-card timing of the BA Schur step: isolates per-observation Jacobians+assembly (ba_blocks), the
dense 6Cx6C solve, and the full ba_step, at the bench shape
(16 cams, 64k points, 8 obs/point).

Usage: python tools/profile_ba.py   (on a GPU machine)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T0 = time.time()


def log(msg):
    print(f"[ba +{time.time() - T0:7.1f}s] {msg}", flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from reconstruction_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import bench as benchmod
    from reconstruction_tpu.ba.bundle_adjust import (
        BAProblem, ba_blocks, ba_step)

    log(f"backend ready: {jax.devices()[0].device_kind}")
    rng = np.random.default_rng(0)
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
    poses0 = jnp.zeros((C, 6), jnp.float32)

    def chain(name, body):
        """Median ms of one jitted ``body(carry)`` call (block_until_ready
        fenced, after a compile+warm call)."""
        t = benchmod.time_call(jax.jit(body), (poses0, prob.points0))
        log(f"{name}: {t * 1e3:.3f} ms")
        return t

    # full step
    chain("ba_step_full", lambda carry: ba_step(
        prob, carry[0], carry[1], C)[:2])

    # blocks only (assembly + Schur reduction, no solves)
    def blocks_only(carry):
        poses, points = carry
        S, b, hpp, b_p, W_t, cost = ba_blocks(prob, poses, points, C)
        # fold outputs back so the chain carries a data dependency
        return (poses + b.reshape(C, 6) * 1e-12,
                points + (b_p[0] + S[0, 0] + W_t[0, 0, 0])[..., None] * 1e-12)

    chain("ba_blocks_only", blocks_only)

    # the dense 6C x 6C solve alone
    S0, b0, Hpp0, bp0, W0, _ = jax.jit(
        lambda: ba_blocks(prob, poses0, prob.points0, C))()
    S0 = S0 + 1e-3 * jnp.eye(C * 6)
    bp0_arr = jnp.stack(bp0, axis=1)

    def solve_only(carry):
        poses, points = carry
        dc = jnp.linalg.solve(S0 + poses[0, 0] * 1e-12, b0)
        return (poses + dc.reshape(C, 6) * 1e-12, points)

    chain("solve_96_only", solve_only)

    # back-substitution (einsum + 3x3 solves) alone

    def backsub_only(carry):
        poses, points = carry
        from reconstruction_tpu.ba.bundle_adjust import _sym3_inv_comps
        rhs = []
        for k in range(3):
            Wk = W0[np.asarray([i * 3 + k for i in range(6)])]
            rhs.append(bp0[k] - (Wk * poses.T[:, :, None]).sum((0, 1)))
        Hinv = _sym3_inv_comps(Hpp0)
        dp = jnp.stack([Hinv[3 * i] * rhs[0] + Hinv[3 * i + 1] * rhs[1]
                        + Hinv[3 * i + 2] * rhs[2] for i in range(3)], axis=1)
        return (poses, points + dp * 1e-12)

    chain("backsub_only", backsub_only)
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())

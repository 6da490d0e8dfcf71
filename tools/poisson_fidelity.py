"""Poisson fidelity study: mesh RMSE vs grid resolution.

The reference runs adaptive-octree Poisson at depth 9 per pair
(`Demo/mesh.bat:1`, ~512^3 effective) and depth 10 globally
(`Demo/meshlab/script1.mlx`).  The in-process solver is a dense grid
(surface/poisson.py); this tool QUANTIFIES the resolution-bounded
fidelity loss SURVEY.md section 7(d) accepted, on two analytic shapes:

  * bumpy sphere  — r(dir) = 1 + 0.04 sin(6x)sin(7y)sin(5z)-style radial
    detail (smooth but fine-scale); RMSE = |F(v)| over mesh vertices of
    the exact implicit.
  * thin torus    — tube radius 0.035 on ring radius 1 (a genuinely thin
    structure: at 64^3 the tube is ~1 voxel and collapses; resolved from
    256^3 up); RMSE of the exact torus SDF + a resolved? flag (mesh
    nonempty with a through-hole-scale vertex count).

Usage:  python tools/poisson_fidelity.py [--cpu] [--res 64,128,256,512]
Prints a markdown table (recorded in BENCH_NOTES.md).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sample_bumpy_sphere(n, rng):
    """Points + exact normals on r(u) = 1 + 0.04 sin(6x) sin(7y) sin(5z)
    (u = unit direction).  F(p) = |p| - r(p/|p|)."""
    import jax
    import jax.numpy as jnp

    def rad(u):
        return 1.0 + 0.04 * (jnp.sin(6.0 * u[..., 0]) * jnp.sin(7.0 * u[..., 1])
                             * jnp.sin(5.0 * u[..., 2]))

    def F(p):  # batched implicit: (..., 3) -> (...)
        nrm = jnp.linalg.norm(p, axis=-1)
        return nrm - rad(p / nrm[..., None])

    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = np.asarray(rad(jnp.asarray(u)))
    pts = u * r[:, None]
    nrm = np.array(jax.vmap(jax.grad(lambda q: F(q)))(jnp.asarray(pts)))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts.astype(np.float32), nrm.astype(np.float32), F


def sample_thin_torus(n, rng, ring=1.0, tube=0.035):
    """Points + exact normals on a torus; SDF is closed-form."""
    th = rng.uniform(0, 2 * np.pi, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    cx = np.stack([ring * np.cos(th), ring * np.sin(th), np.zeros(n)], 1)
    nrm = np.stack([np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th),
                    np.sin(ph)], 1)
    pts = cx + tube * nrm

    def F(p):
        import jax.numpy as jnp
        q = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - ring
        return jnp.sqrt(q ** 2 + p[..., 2] ** 2) - tube

    return pts.astype(np.float32), nrm.astype(np.float32), F


def run_case(name, pts, nrm, F, resolutions):
    import jax
    import jax.numpy as jnp
    from reconstruction_tpu.surface.poisson import poisson_reconstruct
    from reconstruction_tpu.surface.marching import marching_tetrahedra

    rows = []
    for R in resolutions:
        t0 = time.perf_counter()
        pres = poisson_reconstruct(
            jnp.asarray(pts), jnp.asarray(nrm),
            jnp.asarray(np.ones(len(pts), bool)), resolution=R)
        jax.block_until_ready(pres.chi)
        t_solve = time.perf_counter() - t0
        t0 = time.perf_counter()
        verts, faces = marching_tetrahedra(
            np.asarray(pres.chi), float(pres.iso),
            origin=np.asarray(pres.origin), spacing=float(pres.spacing))
        t_march = time.perf_counter() - t0
        if len(verts) == 0:
            rows.append((name, R, float("nan"), 0, t_solve, t_march))
            continue
        err = np.abs(np.asarray(F(jnp.asarray(verts))))
        rows.append((name, R, float(np.sqrt(np.mean(err ** 2))),
                     len(verts), t_solve, t_march))
        print(f"[fidelity] {name} R={R}: rmse={rows[-1][2]:.5f} "
              f"verts={len(verts)} solve={t_solve:.1f}s march={t_march:.1f}s",
              file=sys.stderr, flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", default="64,128,256,512")
    ap.add_argument("--points", type=int, default=300_000)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from reconstruction_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    resolutions = [int(r) for r in args.res.split(",")]

    rng = np.random.default_rng(0)
    rows = []
    pts, nrm, F = sample_bumpy_sphere(args.points, rng)
    rows += run_case("bumpy_sphere", pts, nrm, F, resolutions)
    pts, nrm, F = sample_thin_torus(args.points, rng)
    rows += run_case("thin_torus(r=0.035)", pts, nrm, F, resolutions)

    print("\n| shape | grid | mesh RMSE | verts | solve s | march s |")
    print("|---|---|---|---|---|---|")
    for name, R, rmse, nv, ts, tm in rows:
        print(f"| {name} | {R}^3 | {rmse:.5f} | {nv} | {ts:.1f} | {tm:.1f} |")


if __name__ == "__main__":
    main()

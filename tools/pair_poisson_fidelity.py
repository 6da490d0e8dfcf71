"""Per-pair Poisson fidelity vs grid resolution.

The per-pair scan-mesh grid is a dense grid, while the reference's per-pair PoissonRecon runs at depth 9 (~512^3
effective, `Demo/mesh.bat:1`).  This measures what a grid size costs on a
pair-shaped cloud: an open height-field patch sampled like a rectified
stereo pair (anisotropic density, noise, one-sided), meshed at several
resolutions, scored as mesh-vertex RMSE against the analytic surface.

Run on CPU: python tools/pair_poisson_fidelity.py [N_points]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from reconstruction_tpu.surface.poisson import poisson_reconstruct
    from reconstruction_tpu.surface.marching import marching_tetrahedra
    from reconstruction_tpu.surface.mesh import (clean_mesh, density_trim,
                                                 vertex_density)

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, N)
    y = rng.uniform(-1.0, 1.0, N)

    def f(x, y):
        return 0.3 * np.sin(2.0 * x) * np.cos(1.6 * y) + 0.1 * np.sin(5 * x)

    z = f(x, y)
    eps = 1e-4
    gx = (f(x + eps, y) - f(x - eps, y)) / (2 * eps)
    gy = (f(x, y + eps) - f(x, y - eps)) / (2 * eps)
    nrm = np.stack([-gx, -gy, np.ones_like(gx)], -1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    pts += (nrm * rng.normal(0, 5e-4, (N, 1))).astype(np.float32)
    valid = jnp.asarray(np.ones(N, bool))

    for res in (128, 192, 256, 384, 512):
        t0 = time.perf_counter()
        pr = poisson_reconstruct(jnp.asarray(pts), jnp.asarray(nrm), valid,
                                 resolution=res, cycles=8, point_weight=0.0)
        chi = np.asarray(pr.chi)
        t_solve = time.perf_counter() - t0
        t0 = time.perf_counter()
        verts, faces = marching_tetrahedra(chi, float(pr.iso),
                                           origin=np.asarray(pr.origin),
                                           spacing=float(pr.spacing))
        vg = (verts - np.asarray(pr.origin)) / float(pr.spacing)
        dens = vertex_density(np.asarray(pr.density), vg)
        verts, faces = density_trim(verts, faces, dens, quantile=0.05,
                                    smooth_iters=100)
        verts, faces = clean_mesh(verts, faces)
        t_mesh = time.perf_counter() - t0
        inner = (np.abs(verts[:, 0]) < 1.3) & (np.abs(verts[:, 1]) < 0.85)
        dz = verts[inner][:, 2] - f(verts[inner][:, 0], verts[inner][:, 1])
        rmse = float(np.sqrt((dz ** 2).mean()))
        print(f"res {res:4d}: rmse {rmse:.5f}  verts {len(verts):8d} "
              f"solve {t_solve:6.1f}s mesh {t_mesh:6.1f}s", flush=True)


if __name__ == "__main__":
    main()

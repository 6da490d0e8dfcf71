"""Profile the post-stereo host tail at bench scale (CPU).

This tool times each host-side stage of the post-stereo tail
(filter/MLS/marching/cleanup) standalone on a bench-shaped synthetic
cloud, so host optimizations can be measured without a card.

Usage: python tools/profile_host_tail.py [npoints_millions]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main(n_m: float = 3.3) -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tests"))
    from synthetic import surface_fn

    n = int(n_m * 1e6)
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1.8, 1.8, size=(n, 2)).astype(np.float32)
    z = surface_fn(xy[:, 0], xy[:, 1]).astype(np.float32)
    xyz = np.column_stack([xy, z + rng.normal(scale=2e-3, size=n)
                           .astype(np.float32)])
    # analytic normals for the splat
    eps = 1e-3
    gx = (surface_fn(xy[:, 0] + eps, xy[:, 1])
          - surface_fn(xy[:, 0] - eps, xy[:, 1])) / (2 * eps)
    gy = (surface_fn(xy[:, 0], xy[:, 1] + eps)
          - surface_fn(xy[:, 0], xy[:, 1] - eps)) / (2 * eps)
    nrm = np.column_stack([-gx, -gy, np.ones(n)]).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    col = np.full((n, 3), 127, np.uint8)

    from reconstruction_tpu.config import preset
    cfg = preset("myself")
    # the bench scene spans ~4 units (vs the reference's mm scale)
    mls_radius = 0.02

    spans = {}

    def span(name):
        class S:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *a):
                spans[name] = round(time.perf_counter() - self.t, 2)
                print(f"[tail] {name}: {spans[name]}s", flush=True)
        return S()

    from reconstruction_tpu.cloud.filters import sor_filter
    from reconstruction_tpu.cloud.normals import estimate_normals
    from reconstruction_tpu.cloud.mls import mls_smooth

    os.environ.setdefault("RECON_CLOUD_BACKEND", "native")
    with span("sor"):
        keep = sor_filter(xyz, valid, mean_k=cfg.cloud.sor_mean_k,
                          std_thresh=cfg.cloud.sor_std_thresh,
                          host_points=xyz, host_valid=valid,
                          backend="native")
    with span("normals"):
        nrm_est = estimate_normals(xyz, np.asarray(keep),
                                   radius=mls_radius,
                                   viewpoint=np.array([0, 0, 8], np.float32),
                                   host_points=xyz, host_valid=valid,
                                   backend="native")
    with span("mls"):
        sm, nrm2, ok = mls_smooth(xyz, valid, mls_radius, nrm,
                                  host_points=xyz, host_valid=valid,
                                  backend="native")
    okn = np.asarray(ok)
    xyz_s = np.asarray(sm)[okn]
    nrm_s = np.asarray(nrm2)[okn]
    print(f"[tail] mls kept {len(xyz_s)} pts", flush=True)

    import jax.numpy as jnp
    from reconstruction_tpu.surface.poisson import poisson_reconstruct
    from reconstruction_tpu.surface.marching import marching_tetrahedra
    from reconstruction_tpu.surface.mesh import (
        clean_mesh, close_holes, density_trim, laplacian_smooth,
        remove_small_components, vertex_density)

    with span("poisson"):
        pres = poisson_reconstruct(
            jnp.asarray(xyz_s), jnp.asarray(nrm_s),
            jnp.asarray(np.ones(len(xyz_s), bool)),
            resolution=cfg.surface.grid_resolution,
            cycles=cfg.surface.mg_cycles,
            point_weight=cfg.surface.point_weight)
        jax.block_until_ready(pres.chi)
    with span("marching"):
        verts, faces = marching_tetrahedra(
            np.asarray(pres.chi), float(pres.iso),
            origin=np.asarray(pres.origin), spacing=float(pres.spacing))
    print(f"[tail] marched {len(verts)} verts {len(faces)} faces",
          flush=True)

    with span("trim"):
        vg = (verts - np.asarray(pres.origin)) / float(pres.spacing)
        dens = vertex_density(np.asarray(pres.density), vg)
        verts, faces = density_trim(verts, faces, dens,
                                    quantile=cfg.surface.trim_quantile,
                                    smooth_iters=cfg.surface.trim_smooth_iters)
    with span("components"):
        verts, faces = remove_small_components(
            verts, faces, cfg.surface.min_component_diag_frac)
    with span("clean"):
        verts, faces = clean_mesh(verts, faces)
    with span("laplacian"):
        verts = laplacian_smooth(verts, faces,
                                 iterations=cfg.surface.laplacian_steps,
                                 cotangent=cfg.surface.laplacian_cotangent)
    with span("close_holes"):
        verts, faces = close_holes(verts, faces,
                                   cfg.surface.close_holes_max_edges)
    print(f"[tail] final {len(verts)} verts; spans={spans}", flush=True)


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 3.3)

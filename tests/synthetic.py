"""Synthetic multiview test scenes with analytically known geometry.

Renders a textured height-field surface (smooth bumps on a plane) into
calibrated pinhole views — the test pyramid's ground truth generator
(SURVEY.md section 4: "unit tests per stage against tiny synthetic stereo
scenes with analytically known disparity").
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from reconstruction_tpu.core.camera import Camera, synthetic_rig


def surface_fn(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Height field z(x, y): smooth bumps, |z| <= 0.35."""
    return (0.25 * np.sin(1.3 * x) * np.cos(1.1 * y)
            + 0.1 * np.sin(3.1 * x + 0.7) * np.sin(2.3 * y + 1.1))


def texture_fn(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """High-frequency APERIODIC RGB texture (chirped: local frequency
    varies with position, so no two neighborhoods repeat — keeps NCC
    matching unambiguous).  Values 0..255."""
    r = 127 + 60 * np.sin(7.1 * x + 2.3 * x * x) * np.cos(6.3 * y + 1.7 * y * y)
    g = 127 + 60 * np.sin(5.3 * x + 1.0 + 3.1 * x * y) * np.sin(8.1 * y + 0.5)
    b = 127 + 60 * np.cos(9.7 * x + 2.0 + 2.9 * y * y) * np.cos(4.3 * y + 1.3 * x * x)
    return np.stack([b, g, r], axis=-1)  # BGR like the loaders


def render_view(
    cam: Camera,
    image_size: Tuple[int, int],
    extent: float = 2.0,
    steps: int = 64,
    rows: Tuple[int, int] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the height field into one view: per pixel, march the ray
    to the surface z = f(x, y) and refine the hit by bisection — exact,
    alias-free images (no splat noise), exact masks.  ``rows`` = (r0, r1)
    renders only that band of rows (pixels are independent).

    Returns (image (H, W, 3) float32 BGR, mask (H, W) float32 0/255).
    """
    w, h = image_size
    r0, r1 = rows if rows is not None else (0, h)
    R = np.asarray(cam.R, np.float64)
    t = np.asarray(cam.t, np.float64)
    K = np.asarray(cam.K, np.float64)
    C = -R.T @ t                      # camera center (world)

    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(r0, r1, dtype=np.float64))
    h = r1 - r0
    rays = np.stack([(u - K[0, 2]) / K[0, 0],
                     (v - K[1, 2]) / K[1, 1],
                     np.ones_like(u)], axis=-1)      # camera coords
    dirs = rays @ R                   # world directions (R^T @ ray)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    # Surface height |z| <= 0.35; cameras sit at ~|C| with dirs toward
    # origin.  March t over a bracket that surely contains the surface.
    d2s = np.linalg.norm(C)           # distance to origin
    t0, t1 = d2s - 1.5, d2s + 1.5

    def F(tv):
        p = C[None, None, :] + tv[..., None] * dirs
        return p[..., 2] - surface_fn(p[..., 0], p[..., 1])

    # Find the first sign change along each ray.
    ts = np.linspace(t0, t1, steps)
    prev_t = np.full((h, w), t0)
    prev_F = F(np.full((h, w), t0))
    lo = np.full((h, w), np.nan)
    hi = np.full((h, w), np.nan)
    for k in range(1, steps):
        cur_t = np.full((h, w), ts[k])
        cur_F = F(cur_t)
        new = np.isnan(lo) & (np.sign(cur_F) != np.sign(prev_F))
        lo = np.where(new, prev_t, lo)
        hi = np.where(new, cur_t, hi)
        prev_t, prev_F = cur_t, cur_F
    hit = np.isfinite(lo)
    lo = np.where(hit, lo, t0)
    hi = np.where(hit, hi, t1)
    for _ in range(40):               # bisection to ~1e-12
        mid = 0.5 * (lo + hi)
        fm = F(mid)
        flo = F(lo)
        same = np.sign(fm) == np.sign(flo)
        lo = np.where(same, mid, lo)
        hi = np.where(same, hi, mid)
    tmid = 0.5 * (lo + hi)
    p = C[None, None, :] + tmid[..., None] * dirs
    inside = hit & (np.abs(p[..., 0]) < extent) & (np.abs(p[..., 1]) < extent)
    img = np.where(inside[..., None],
                   texture_fn(p[..., 0], p[..., 1]), 0.0).astype(np.float32)
    mask = inside.astype(np.float32) * 255.0
    return img, mask


def ground_truth_cloud(extent: float = 2.0, grid: int = 200) -> np.ndarray:
    xs = np.linspace(-extent * 0.8, extent * 0.8, grid)
    X, Y = np.meshgrid(xs, xs)
    Z = surface_fn(X, Y)
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3)


def _render_np(K: np.ndarray, Rt: np.ndarray, image_size: Tuple[int, int],
               rows: Tuple[int, int]):
    """render_view of one row band from plain host matrices (pool
    worker entry)."""
    from types import SimpleNamespace
    return render_view(SimpleNamespace(K=K, R=Rt[:, :3], t=Rt[:, 3]),
                       image_size, rows=rows)


def _cpu_only_worker():
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"


def make_stereo_scene(
    image_size: Tuple[int, int] = (320, 240),
    span_deg: float = 7.0,
    num_cameras: int = 2,
    focal: float | None = None,
    processes: int = 1,
) -> Tuple[List[Camera], List[np.ndarray], List[np.ndarray]]:
    """Cameras + rendered images + masks for an inward-facing rig.

    processes > 1 renders row bands of the views in that many spawned
    worker processes (same pixels; the workers never touch an
    accelerator)."""
    focal = focal if focal is not None else image_size[0] * 1.6
    cams = synthetic_rig(num_cameras=num_cameras, radius=8.0,
                         span_deg=span_deg, focal=focal,
                         image_size=image_size)
    if processes > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        h = image_size[1]
        bands = -(-processes // len(cams))
        edges = [h * i // bands for i in range(bands + 1)]
        jobs = [(np.asarray(c.K), np.asarray(c.Rt), image_size, (a, b))
                for c in cams for a, b in zip(edges[:-1], edges[1:])]
        with ProcessPoolExecutor(
                max_workers=processes, initializer=_cpu_only_worker,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            parts = list(pool.map(_render_np, *zip(*jobs)))
        views = [tuple(np.concatenate([p[k] for p in
                                       parts[i * bands:(i + 1) * bands]])
                       for k in (0, 1)) for i in range(len(cams))]
    else:
        views = [render_view(c, image_size) for c in cams]
    imgs = [img for img, _ in views]
    masks = [mask for _, mask in views]
    return cams, imgs, masks


def point_to_surface_rmse(points: np.ndarray, clip: float = 1.6) -> float:
    """RMSE of |z - surface(x, y)| over points inside the core region —
    the analytic stand-in for point-to-mesh RMSE."""
    sel = (np.abs(points[:, 0]) < clip) & (np.abs(points[:, 1]) < clip)
    p = points[sel]
    if len(p) == 0:
        return float("inf")
    dz = p[:, 2] - surface_fn(p[:, 0], p[:, 1])
    return float(np.sqrt(np.mean(dz ** 2)))

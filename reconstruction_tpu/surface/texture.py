"""Multi-view vertex texturing.

Replaces TextureStitcher.exe (`CCloudOptimization.cpp:396`) and the
single-view recolor primitive `texture_color`
(`CCloudOptimization.cpp:400-421`, `my_ply_interface.cpp`): every vertex
projects into each camera (world -> scaled rectified pixels via the
reference's `cam.P` convention, `CStereoMatching.cpp:145`), samples the
rectified image bilinearly, and blends views weighted by mask validity
and normal-to-view alignment.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.config import GEOMETRY_PRECISION


def project_vertices(P: jnp.ndarray, verts: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World -> pixel coords through a 3x4 projection.  Returns (uv, z)."""
    vh = jnp.concatenate([verts, jnp.ones_like(verts[:, :1])], axis=1)
    p = jnp.matmul(vh, jnp.asarray(P, jnp.float32).T, precision=GEOMETRY_PRECISION)
    z = p[:, 2]
    uv = p[:, :2] / jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)[:, None]
    return uv, z


def _bilinear(img: jnp.ndarray, uv: jnp.ndarray, fill: float = 127.0) -> jnp.ndarray:
    H, W = img.shape[:2]
    x, y = uv[:, 0], uv[:, 1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]
        return jnp.where(ok[:, None], val, fill)

    v = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
         + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    return v


def texture_single_view(
    verts: np.ndarray,
    P: np.ndarray,
    image: np.ndarray,
) -> np.ndarray:
    """Single-view recolor (the reference's per-pair `color_<pair>_k.ply`
    path, `CCloudOptimization.cpp:127-143`): nearest-pixel sample, gray
    (127,127,127) outside (`:412-415`).  Pure host math — the values are
    immediately written to PLY, so a device round trip buys nothing."""
    verts = np.asarray(verts, np.float32)
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1)
    p = vh @ np.asarray(P, np.float32).T
    z = p[:, 2]
    uv = p[:, :2] / np.where(np.abs(z) > 1e-12, z, 1e-12)[:, None]
    uvr = np.round(uv).astype(np.int64)
    H, W = image.shape[:2]
    ok = ((uvr[:, 0] >= 0) & (uvr[:, 0] < W)
          & (uvr[:, 1] >= 0) & (uvr[:, 1] < H))
    img = np.asarray(image, np.float32)
    col = img[np.clip(uvr[:, 1], 0, H - 1), np.clip(uvr[:, 0], 0, W - 1)]
    return np.where(ok[:, None], col, 127.0)


def _bilinear_np(img: np.ndarray, uv: np.ndarray, fill: float) -> np.ndarray:
    """Numpy twin of _bilinear (same taps, same out-of-bounds fill)."""
    H, W = img.shape[:2]
    x, y = uv[:, 0], uv[:, 1]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(ok[:, None], val, fill)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def texture_vertices_np(verts, normals, cameras) -> np.ndarray:
    """Pure-host texture blend (same math as texture_vertices), used on
    the native backend."""
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    acc = np.zeros((len(verts), 3), np.float32)
    wacc = np.zeros((len(verts),), np.float32)
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1)
    for P, image, mask, center in cameras:
        p = vh @ np.asarray(P, np.float32).T
        z = p[:, 2]
        uv = p[:, :2] / np.where(np.abs(z) > 1e-12, z, 1e-12)[:, None]
        col = _bilinear_np(np.asarray(image, np.float32), uv, 127.0)
        mval = _bilinear_np(np.asarray(mask, np.float32)[..., None],
                            uv, 0.0)[:, 0]
        view_dir = np.asarray(center, np.float32)[None] - verts
        view_dir /= np.maximum(
            np.linalg.norm(view_dir, axis=1, keepdims=True), 1e-9)
        facing = (normals * view_dir).sum(1)
        w = np.maximum(facing, 0.0) * (mval > 200.0) * (z > 0)
        acc += col * w[:, None].astype(np.float32)
        wacc += w.astype(np.float32)
    return np.where(wacc[:, None] > 1e-6,
                    acc / np.maximum(wacc, 1e-6)[:, None], 127.0)


def texture_vertices(
    verts: np.ndarray,
    normals: np.ndarray,
    cameras: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    backend: str = "auto",
) -> np.ndarray:
    """Blend vertex colors over views.

    Args:
      verts: (V, 3) world positions.
      normals: (V, 3) vertex normals (for view weighting).
      cameras: per view (P 3x4 world->pixel, image (H, W, 3), mask (H, W),
        center (3,) world camera center).
      backend: "jax", "native" (numpy host blend) or "auto"
        (cloud/backend.py resolution).

    Returns (V, 3) colors (BGR, 0..255).
    """
    from reconstruction_tpu.cloud.backend import resolve_backend
    if resolve_backend(backend) == "native":
        return texture_vertices_np(verts, normals, cameras)
    verts_j = jnp.asarray(verts, jnp.float32)
    normals_j = jnp.asarray(normals, jnp.float32)
    acc = jnp.zeros((len(verts), 3), jnp.float32)
    wacc = jnp.zeros((len(verts),), jnp.float32)
    for P, image, mask, center in cameras:
        uv, z = project_vertices(jnp.asarray(P), verts_j)
        col = _bilinear(jnp.asarray(image, jnp.float32), uv)
        mval = _bilinear(jnp.asarray(mask, jnp.float32)[..., None], uv, 0.0)[:, 0]
        view_dir = jnp.asarray(center, jnp.float32)[None] - verts_j
        view_dir = view_dir / jnp.maximum(
            jnp.linalg.norm(view_dir, axis=1, keepdims=True), 1e-9)
        facing = jnp.sum(normals_j * view_dir, axis=1)
        w = jnp.maximum(facing, 0.0) * (mval > 200.0) * (z > 0)
        acc = acc + col * w[:, None]
        wacc = wacc + w
    out = jnp.where(wacc[:, None] > 1e-6, acc / jnp.maximum(wacc, 1e-6)[:, None],
                    127.0)
    return np.asarray(out)

"""Disparity -> world-space point cloud.

Replaces `CStereoMatching::DisparityToCloud` (`CStereoMatching.cpp:682-761`):
Q-matrix reprojection with the reference's scale handling (`_Q.col(3) *=
scale`, `:698`), extra mask erosion by 2% of image height (`:703-705`),
rectified-cam -> world transform (`:749`), and BGR color sampling from the
rectified image (`:735,741`).

Output is a fixed-capacity padded buffer + validity mask (no data-dependent
shapes under jit; SURVEY.md section 7 hard part (e)).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.config import GEOMETRY_PRECISION, NOMATCH
from reconstruction_tpu.core.morphology import erode_mask, valid_mask
from reconstruction_tpu.stereo.margins import Margins, inner_box


class PointCloud(NamedTuple):
    """Padded point buffer: xyz (N, 3), colors (N, 3) BGR, valid (N,)."""

    xyz: jnp.ndarray
    colors: jnp.ndarray
    valid: jnp.ndarray

    def compact(self) -> "PointCloud":
        """Host-side: drop invalid rows (numpy)."""
        v = np.asarray(self.valid)
        return PointCloud(
            xyz=np.asarray(self.xyz)[v],
            colors=np.asarray(self.colors)[v],
            valid=np.ones(int(v.sum()), bool),
        )


@partial(jax.jit, static_argnames=("erode_frac",))
def disparity_to_cloud(
    disp: jnp.ndarray,
    mask: jnp.ndarray,
    image: jnp.ndarray,
    Q: jnp.ndarray,
    R_final: jnp.ndarray,
    T_final: jnp.ndarray,
    m: Margins,
    scale: float,
    erode_frac: float = 0.02,
) -> PointCloud:
    """Triangulate one disparity map.

    Args:
      disp: (H, W) disparity (d = x_r - x_l), NOMATCH holes.
      mask: (H, W) [0,255] mask of the source view.
      image: (H, W, 3) rectified source image (BGR) for colors.
      Q: 4x4 reprojection matrix (reference sign convention).
      R_final, T_final: rectified-cam -> world.
      m: source-view margins.
      scale: LowestLevelWidth / OriginWidth * 2^level (`:692`).
    """
    H, W = disp.shape
    erode_size = int(np.ceil(erode_frac * H))
    mask_e = erode_mask(mask, erode_size) if erode_size > 1 else mask
    ok = valid_mask(mask_e) & (disp != NOMATCH) & inner_box(m, H, W)

    Qs = jnp.asarray(Q, jnp.float32)
    Qs = Qs.at[:, 3].multiply(scale)
    q03, q13, q23, q32, q33 = Qs[0, 3], Qs[1, 3], Qs[2, 3], Qs[3, 2], Qs[3, 3]

    y = jnp.arange(H, dtype=jnp.float32)[:, None]
    x = jnp.arange(W, dtype=jnp.float32)[None, :]
    iW = 1.0 / (q33 + q32 * disp)
    X = (q03 + x) * iW
    Y = (y + q13) * iW
    Z = q23 * iW * jnp.ones_like(X)
    F = jnp.stack([X, Y, Z], axis=-1)                      # (H, W, 3)
    world = jnp.einsum("ij,hwj->hwi", jnp.asarray(R_final, jnp.float32), F,
                       precision=GEOMETRY_PRECISION)
    world = world + jnp.asarray(T_final, jnp.float32)

    # Colors stay uint8: they only ever feed PLY writers (7 MB per
    # 1920x1280 pair instead of 28 MB as f32).
    colors = jnp.clip(image, 0, 255).astype(jnp.uint8)
    return PointCloud(
        xyz=world.reshape(-1, 3),
        colors=colors.reshape(-1, 3),
        valid=ok.reshape(-1),
    )


def disparity_to_cloud_np(
    disp: np.ndarray,
    mask_u8: np.ndarray,
    image_u8: np.ndarray,
    Q: np.ndarray,
    R_final: np.ndarray,
    T_final: np.ndarray,
    margins: np.ndarray,
    scale: float,
    erode_frac: float = 0.02,
) -> PointCloud:
    """Host twin of disparity_to_cloud (same f32 math, same ellipse
    erosion via scipy border_value=1 == the device conv's outside-is-
    valid padding).  Used on the native backend and by the pair-sharded
    path: disparity, the finest mask and the rectified image are already
    host-resident after the packed fetch.

    margins: (4,) int array (YL, YR, XL, XR) — the fetched Margins in
    field order.
    """
    from reconstruction_tpu.core.morphology import ellipse_kernel

    H, W = disp.shape
    erode_size = int(np.ceil(erode_frac * H))
    valid = np.asarray(mask_u8, np.float32) >= 254.5
    if erode_size > 1:
        from scipy.ndimage import binary_erosion
        se = ellipse_kernel(erode_size, erode_size) > 0
        valid = binary_erosion(valid, structure=se, border_value=1)
    YL, YR, XL, XR = (int(v) for v in margins)
    y = np.arange(H, dtype=np.float32)[:, None]
    x = np.arange(W, dtype=np.float32)[None, :]
    inner = ((y >= YL) & (y <= YR) & (x >= XL) & (x <= XR))
    disp = np.asarray(disp, np.float32)
    ok = valid & (disp != NOMATCH) & inner

    Qs = np.asarray(Q, np.float32).copy()
    Qs[:, 3] *= np.float32(scale)
    q03, q13, q23 = Qs[0, 3], Qs[1, 3], Qs[2, 3]
    q32, q33 = Qs[3, 2], Qs[3, 3]
    iW = np.float32(1.0) / (q33 + q32 * disp)
    X = (q03 + x.astype(np.float32)) * iW
    Y = (y.astype(np.float32) + q13) * iW
    Z = (q23 * iW) * np.ones_like(X)
    F = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    world = F @ np.asarray(R_final, np.float32).T
    world = world + np.asarray(T_final, np.float32)

    return PointCloud(
        xyz=world.reshape(-1, 3),
        colors=np.ascontiguousarray(image_u8).reshape(-1, 3),
        valid=ok.reshape(-1),
    )

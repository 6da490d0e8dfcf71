"""Zero-mean NCC window machinery.

The reference's `CManageData::WindowToVec` (`CManageData.cpp:81-90`,
`CManageData.h:45-59`) extracts a (2r+1)^2 x 3-channel window, subtracts its
mean and returns the L2 norm (0 -> 1).  Matching scores are
dot(vecL, vecR) / (normL * normR) — zero-mean NCC.

Array formulation: descriptors become a dense (H, W, K) tensor built
from static shifts, so the level-0 brute-force scan
(`CStereoMatching.cpp:207-218`) collapses into one batched matmul per
scanline producing the full W x W score matrix — which serves BOTH match
directions at once (the reference computes them separately,
`CStereoMatching.cpp:55-56`).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """out[y, x] = img[y+dy, x+dx] with zero padding (static shifts)."""
    H, W = img.shape[:2]
    py0, py1 = max(-dy, 0), max(dy, 0)
    px0, px1 = max(-dx, 0), max(dx, 0)
    pad = ((py0, py1), (px0, px1)) + ((0, 0),) * (img.ndim - 2)
    x = jnp.pad(img, pad)
    return x[py1 : py1 + H, px1 : px1 + W]


@partial(jax.jit, static_argnames=("radius",))
def window_descriptors(img: jnp.ndarray, radius: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense zero-mean normalized window descriptors.

    Args:
      img: (H, W, C) float32 image.
      radius: window radius r; window is (2r+1) x (2r+1) x C.

    Returns:
      (desc, norm): desc (H, W, K) with K = (2r+1)^2 * C, zero-mean and
      L2-normalized per window (norm 0 -> 1, `CManageData.cpp:89`);
      norm (H, W) the pre-normalization L2 norms.

    Windows extending past the image read zeros (the reference reads
    whatever memory is there; callers must mask border pixels, which the
    eroded masks + margins already do).
    """
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    w = 2 * radius + 1
    cols = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            cols.append(shifted(img, dy, dx))
    desc = jnp.concatenate(cols, axis=-1)  # (H, W, w*w*C)
    mean = desc.mean(axis=-1, keepdims=True)
    desc = desc - mean
    norm = jnp.linalg.norm(desc, axis=-1)
    safe = jnp.where(norm == 0, 1.0, norm)
    return desc / safe[..., None], norm


def row_score_matrix(descL: jnp.ndarray, descR: jnp.ndarray) -> jnp.ndarray:
    """Full per-scanline NCC score matrices.

    Args:
      descL, descR: (H, W, K) normalized descriptors.

    Returns:
      (H, W, W) scores[y, x, x'] = NCC(left window at (y,x),
      right window at (y,x')).  One batched matmul.
    """
    return jnp.einsum("hwk,hvk->hwv", descL, descR,
                      preferred_element_type=jnp.float32)

"""Foreground mask generation (background-subtraction NCC + morphology +
region growing).

Replaces the MATLAB/mex preprocessing (`Demo/segmentation/CutImageDir.m`,
`CutImageDir_canon.m`, `RegionGrowing.m`, `RegionGrowing_mex.cpp`):

  1. background model: blurred mean of background frames (`CutImageDir.m:10-20`),
  2. per-pixel NCC score S between frame and background over a small
     window; foreground where S < threshold (0.4; canon variant 0.9 on
     1-S, `CutImageDir.m:40-46`, `CutImageDir_canon.m:26-53`),
  3. morphological close/fill/open,
  4. keep the connected component containing the image center,
  5. region growing from the border with intensity criterion
     |region_mean - I| < max_dif (`RegionGrowing_mex.cpp:153-266`) to
     carve away background bleed, then final morphology.

Array formulation: the NCC score is the stereo box-filter NCC at shift 0; the
flood fill is an iterative masked-dilation fixed point under
`lax.while_loop`; connected-component selection is one labeled pass on
host (scipy) since it runs once per frame at preprocessing time.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.stereo.matching import ncc_moments, _box_sum
from reconstruction_tpu.stereo.ncc import shifted


@partial(jax.jit, static_argnames=("radius",))
def background_ncc_score(img: jnp.ndarray, bg: jnp.ndarray,
                         radius: int = 2) -> jnp.ndarray:
    """Zero-mean NCC between the frame and the background model at each
    pixel (windowed) — high where the frame matches the background."""
    a = img.astype(jnp.float32) - 128.0
    b = bg.astype(jnp.float32) - 128.0
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    ma = ncc_moments(a, radius)
    mb = ncc_moments(b, radius)
    cross = _box_sum((a * b).sum(-1), radius)
    return (cross - ma.n * ma.mean * mb.mean) * ma.inv_norm * mb.inv_norm


def _binary_morph(mask: jnp.ndarray, op: str, radius: int) -> jnp.ndarray:
    """Disk open/close/dilate/erode via conv counting."""
    from reconstruction_tpu.core.morphology import ellipse_kernel
    se = jnp.asarray(ellipse_kernel(2 * radius + 1, 2 * radius + 1))

    def dil(m):
        h = jax.lax.conv_general_dilated(
            m.astype(jnp.float32)[None, None], se[None, None], (1, 1),
            [(radius, radius), (radius, radius)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]
        return h > 0.5

    def ero(m):
        return ~dil(~m)

    if op == "dilate":
        return dil(mask)
    if op == "erode":
        return ero(mask)
    if op == "open":
        return dil(ero(mask))
    if op == "close":
        return ero(dil(mask))
    raise ValueError(op)


@partial(jax.jit, static_argnames=("max_iters",))
def flood_fill(seed: jnp.ndarray, allowed: jnp.ndarray,
               max_iters: int = 4096) -> jnp.ndarray:
    """Fixed point of masked 4-neighbor dilation: all `allowed` pixels
    reachable from `seed` (the jnp analogue of the mex region growing's
    spatial spread; the intensity criterion folds into `allowed`)."""

    def cond(state):
        cur, prev, it = state
        return (it < max_iters) & (cur != prev).any()

    def body(state):
        cur, _, it = state
        grown = (cur | shifted(cur, 0, 1) | shifted(cur, 0, -1)
                 | shifted(cur, 1, 0) | shifted(cur, -1, 0)) & allowed
        return grown, cur, it + 1

    out, _, _ = jax.lax.while_loop(
        cond, body, (seed & allowed, jnp.zeros_like(seed), 0))
    return out


def region_growing(img: jnp.ndarray, seed_xy: Tuple[int, int],
                   max_dif: float, iters: int = 64) -> jnp.ndarray:
    """Region growing with a running region mean
    (`RegionGrowing_mex.cpp:153-266`): alternate between flood-fill over
    the |mean - I| < max_dif level set and mean re-estimation."""
    g = img.astype(jnp.float32)
    seed = jnp.zeros(g.shape, bool).at[seed_xy[1], seed_xy[0]].set(True)
    region = seed
    mean = g[seed_xy[1], seed_xy[0]]
    for _ in range(4):  # a few mean refinements
        allowed = jnp.abs(g - mean) < max_dif
        region = flood_fill(region | seed, allowed, max_iters=iters)
        mean = jnp.where(region, g, 0.0).sum() / jnp.maximum(region.sum(), 1)
    return region


def segment_frame(
    img: np.ndarray,
    background: np.ndarray,
    threshold: float = 0.4,
    radius: int = 2,
) -> np.ndarray:
    """Full per-frame mask (`CutOneImage`, `CutImageDir.m:29-70`).

    Returns a float mask in {0, 255}.
    """
    from scipy import ndimage
    S = np.asarray(background_ncc_score(jnp.asarray(img),
                                        jnp.asarray(background), radius))
    fg = S < threshold
    fg = np.asarray(_binary_morph(jnp.asarray(fg), "close", 3))
    fg = ndimage.binary_fill_holes(fg)
    fg = np.asarray(_binary_morph(jnp.asarray(fg), "open", 2))

    # keep the component containing the image center (`:47-49`)
    lab, n = ndimage.label(fg)
    cy, cx = np.asarray(fg.shape) // 2
    target = lab[cy, cx]
    if target == 0 and n > 0:
        sizes = ndimage.sum(fg, lab, index=range(1, n + 1))
        target = 1 + int(np.argmax(sizes))
    fg = lab == target

    # region-grow the BACKGROUND from the border to carve bleed (`:53`)
    gray = img.mean(-1) if img.ndim == 3 else img
    border_seed = np.zeros_like(fg)
    border_seed[0, :] = border_seed[-1, :] = True
    border_seed[:, 0] = border_seed[:, -1] = True
    bg_region = np.asarray(region_growing(
        jnp.asarray(gray), (1, 1), max_dif=0.2 * 255, iters=max(fg.shape)))
    fg = fg & ~bg_region

    fg = ndimage.binary_fill_holes(fg)
    lab, n = ndimage.label(fg)
    if n > 1:
        sizes = ndimage.sum(fg, lab, index=range(1, n + 1))
        fg = lab == (1 + int(np.argmax(sizes)))
    return fg.astype(np.float32) * 255.0


def cut_image_dir(indir: str, outdir: Optional[str] = None,
                  cameras: int = 10, threshold: float = 0.4) -> None:
    """Directory driver (`CutImageDir.m:1-27`): background model per
    camera from the bg/ subdir (or frame mean), then per-frame masks
    into mask/."""
    from reconstruction_tpu.io.images import imread, imwrite
    outdir = outdir or os.path.join(indir, "mask")
    os.makedirs(outdir, exist_ok=True)
    files = sorted(os.listdir(indir))
    for cam in range(cameras):
        cam_files = [f for f in files if f.endswith(f"_Cam{cam}.jpg")]
        if not cam_files:
            continue
        imgs = [imread(os.path.join(indir, f)) for f in cam_files]
        bg = np.mean(imgs, axis=0)
        for f, img in zip(cam_files, imgs):
            mask = segment_frame(img, bg, threshold)
            imwrite(os.path.join(outdir, f), mask)

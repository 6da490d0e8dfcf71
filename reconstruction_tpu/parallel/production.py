"""Production pair-sharded stereo: all camera pairs as ONE SPMD program.

The reference iterates camera pairs strictly sequentially
(`CStereoMatching.cpp:17`); SURVEY.md's parallelism table names the pair
axis as the primary scale-out target.  r3 shipped the sharded level
program (`parallel/sharded.match_level_pairs_sharded`) only as a tested
component; this module makes it the production stereo front-end:
`match_pairs_sharded` produces the same per-pair `PairResult`s the
sequential `stereo.pipeline.match_pair` yields, so the orchestrator's
cloud/surface/texture stages run unchanged downstream
(`pipeline.reconstruct.reconstruct(mesh=...)`).

Design notes:
  * Rectification runs on the host per pair.  Each pair's remap runs
    on the device that holds its shard of the mesh's `pair` axis, and
    the sharded inputs are assembled from those per-device pieces, so
    no device stages the other devices' pairs.
  * Pyramids, the per-level recipe, and the drift telemetry run batched
    (vmap over pairs) inside the SPMD program — zero cross-pair
    communication until cloud fusion.
  * The pair count pads up to a multiple of the pair-axis size with
    repeats of pair 0; padded lanes are dropped after the fetch.
  * Triangulation runs on host from the single packed fetch
    (`disparity_to_cloud_np` == the device path,
    tests/test_native_cloud.py), exactly like the native backend in
    sequential mode.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from reconstruction_tpu.config import ReconstructionConfig
from reconstruction_tpu.core.pyramid import build_pyramid, quantize_u8
from reconstruction_tpu.core.rectify import rectify_pair
from reconstruction_tpu.core.morphology import valid_mask
from reconstruction_tpu.stereo.margins import Margins, find_margin
from reconstruction_tpu.stereo.pipeline import PairResult, remap_pair_views
from reconstruction_tpu.stereo.triangulate import disparity_to_cloud_np
from reconstruction_tpu.parallel.sharded import match_level_pairs_sharded
from reconstruction_tpu.utils.transfer import fetch_packed


def match_pairs_sharded(
    cfg: ReconstructionConfig,
    pairs: Sequence,
    mesh: Mesh,
) -> List[PairResult]:
    """Run the full per-pair stereo recipe for ALL pairs, pair-sharded.

    `pairs` is a sequence of `pipeline.reconstruct.PairInput`.  Returns
    one PairResult per input pair (host-resident arrays), matching the
    sequential `match_pair` outputs.
    """
    n_real = len(pairs)
    n_axis = mesh.shape["pair"]
    n_pad = (-n_real) % n_axis

    from reconstruction_tpu.cloud.backend import resolve_backend
    use_native = resolve_backend(cfg.cloud.backend) == "native"

    working = cfg.finest_size
    pair_shard = NamedSharding(mesh, P("pair"))
    n_lanes = n_real + n_pad
    # {device: the pair lanes it holds} of a pair-sharded array
    lanes_of = {d: range(n_lanes)[idx[0]] for d, idx in
                pair_shard.addressable_devices_indices_map(
                    (n_lanes,)).items()}
    home = {i: d for d, lanes in lanes_of.items() for i in lanes}
    rects, imgs_d, masks_d, raw_d = [], [], [], []
    host_im, host_rm, host_er = [], [], []
    for i, pin in enumerate(pairs):
        origin_size = (pin.image0.shape[1], pin.image0.shape[0])
        rect = rectify_pair(pin.K0, pin.Rt0, pin.K1, pin.Rt1,
                            origin_size, working)
        with jax.default_device(home[i]):
            imgs, masks, raw_masks, h_im, h_rm, h_er = remap_pair_views(
                cfg, pin.image0, pin.image1, pin.mask0, pin.mask1,
                pin.K0, pin.K1, rect, working, use_native)
        rects.append(rect)
        imgs_d.append(imgs)
        masks_d.append(masks)
        raw_d.append(raw_masks)
        host_im.append(h_im)
        host_rm.append(h_rm)
        host_er.append(h_er)

    def put(view_lists, k):
        """Pair-sharded (n_lanes, ...) array built shard by shard on the
        shard's own device (padded lanes repeat pair 0)."""
        arrs = [vl[k] for vl in view_lists]
        arrs += [arrs[0]] * n_pad
        shards = [jnp.stack([jax.device_put(arrs[i], d) for i in lanes])
                  for d, lanes in lanes_of.items()]
        return jax.make_array_from_single_device_arrays(
            (n_lanes,) + arrs[0].shape, pair_shard, shards)

    have_host_imgs = bool(host_im[0])
    I0 = put(imgs_d, 0)
    I1 = put(imgs_d, 1)
    M0 = put(masks_d, 0)
    M1 = put(masks_d, 1)
    if not have_host_imgs:
        # Raw (pre-erosion) masks only feed the packed fetch on the jax
        # path; in native mode they stay host-side (remap_pair_views
        # returns None entries).
        R0 = put(raw_d, 0)
        R1 = put(raw_d, 1)

    # Batched pyramids (`ConstructPyrm`, `CStereoMatching.cpp:1040-1053`).
    L = cfg.pyramid_levels
    pyr = jax.jit(jax.vmap(lambda a, b, c, d: tuple(
        build_pyramid(x, L) for x in (a, b, c, d))))(I0, I1, M0, M1)
    pyr0, pyr1, mp0, mp1 = pyr

    state = None
    drifts = []
    for level in range(L):
        state = match_level_pairs_sharded(
            mesh,
            quantize_u8(pyr0[level]), quantize_u8(pyr1[level]),
            quantize_u8(mp0[level]), quantize_u8(mp1[level]),
            state, level,
            radius=cfg.stereo.block_radius,
            offset=cfg.stereo.disparity_offset,
            ws=cfg.stereo.refine_ws,
            refine_iters=cfg.refine_iterations(level),
            median_iters=cfg.stereo.median_iterations,
            recenter_every=cfg.stereo.refine_recenter_every,
        )
        drifts.append(jnp.stack([state.refine_drift0,
                                 state.refine_drift1], axis=1))

    finest = L - 1
    radius = cfg.stereo.block_radius

    @jax.jit
    def finest_meta(mask0, mask1):
        m0 = jax.vmap(lambda v: find_margin(v, radius))(
            jax.vmap(valid_mask)(mask0))
        m1 = jax.vmap(lambda v: find_margin(v, radius))(
            jax.vmap(valid_mask)(mask1))
        pack = lambda m: jnp.stack([m.YL, m.YR, m.XL, m.XR], axis=1)
        return pack(m0), pack(m1)

    mg0, mg1 = finest_meta(quantize_u8(mp0[finest]),
                           quantize_u8(mp1[finest]))

    to_u8 = lambda a: jnp.clip(a, 0, 255).astype(jnp.uint8)
    fetch = [state.disp0, jnp.stack(drifts, axis=1), mg0, mg1]
    if not have_host_imgs:
        fetch += [to_u8(quantize_u8(mp0[finest])),
                  to_u8(I0), to_u8(I1),
                  to_u8(quantize_u8(R0)), to_u8(quantize_u8(R1))]
    if cfg.cloud.dedup and not have_host_imgs:
        fetch += [to_u8(M0), to_u8(M1)]
    out = fetch_packed(fetch)
    disp_h, drifts_h, mg0_h, mg1_h = out[:4]
    pos = 4
    if not have_host_imgs:
        fmask_h, I0_h, I1_h, R0_h, R1_h = out[pos:pos + 5]
        pos += 5
    if cfg.cloud.dedup and not have_host_imgs:
        EM0_h, EM1_h = out[pos:pos + 2]

    origin_w = pairs[0].image0.shape[1]
    scale = cfg.lowest_level_size[0] / origin_w * (1 << finest)

    results = []
    for i in range(n_real):
        rect = rects[i]
        if have_host_imgs:
            im0_h, im1_h = host_im[i]
            rm0_h, rm1_h = host_rm[i]
            fmask_i = host_er[i][0].astype(np.uint8) * 255
        else:
            im0_h, im1_h = I0_h[i], I1_h[i]
            rm0_h, rm1_h = R0_h[i], R1_h[i]
            fmask_i = fmask_h[i]
        cloud = disparity_to_cloud_np(
            disp_h[i], fmask_i, im0_h, rect.Q, rect.R_final,
            rect.T_final, mg0_h[i], scale,
            erode_frac=cfg.stereo.cloud_erode_frac)
        if cfg.cloud.dedup:
            em = ((host_er[i][0].astype(np.uint8) * 255,
                   host_er[i][1].astype(np.uint8) * 255)
                  if have_host_imgs else (EM0_h[i], EM1_h[i]))
        else:
            em = (None, None)
        results.append(PairResult(
            disparity=disp_h[i],
            cloud=cloud,
            rectification=rect,
            margins0=Margins(*(int(v) for v in mg0_h[i])),
            margins1=Margins(*(int(v) for v in mg1_h[i])),
            rect_images=(im0_h, im1_h),
            rect_masks=(rm0_h, rm1_h),
            refine_drift=drifts_h[i],
            rect_masks_eroded=em,
        ))
    return results

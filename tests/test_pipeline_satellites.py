"""Satellite pipeline tests: batch config gen, kinect converter,
segmentation, checkpoint store, scan meshes, decimation/subdivision,
watchdog, profiling."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from reconstruction_tpu.pipeline.batch import generate_take_config
from reconstruction_tpu.pipeline.checkpoint import StageStore
from reconstruction_tpu.pipeline.kinect import depth_to_points
from reconstruction_tpu.pipeline.segmentation import (
    background_ncc_score, flood_fill, segment_frame)
from reconstruction_tpu.surface.simplify import decimate_mesh, loop_subdivide
from reconstruction_tpu.utils.watchdog import (
    StageTimeout, check_finite, run_with_deadline)
from reconstruction_tpu.utils.profiling import (
    DEVICE_PEAKS, ncc_sweep_cost, refine_cost)


def test_batch_config_matches_reference_shape():
    cfg = generate_take_config("/in", "/out", 0)
    assert cfg.pyramid_levels == 4
    assert cfg.lowest_level_size == (160, 240)
    assert cfg.cam_pairs == ((0, 1), (2, 3), (4, 5), (7, 6))
    assert cfg.imagelist[3] == "0001_Cam3.jpg"
    assert cfg.masklist[3].endswith("0001_Cam3.jpg")


def test_kinect_depth_to_points():
    H, W = 24, 32
    depth = np.zeros((H, W), np.float32)
    bg = np.full((H, W), 2000.0, np.float32)
    depth[10, 10] = 1000.0   # kept: bg-d=1000>500
    depth[10, 11] = 1800.0   # dropped: bg-d=200
    depth[5, 5] = 1000.0
    bg[5, 5] = 50.0          # dropped: bg<100
    intr = jnp.asarray([100.0, 100.0, 16.0, 12.0])
    bbox = jnp.asarray([0.0, W, 0.0, H])
    pts, ok = depth_to_points(jnp.asarray(depth), jnp.asarray(bg), intr, bbox)
    okn = np.asarray(ok)
    assert okn.sum() == 1
    p = np.asarray(pts)[okn][0]
    np.testing.assert_allclose(p, [(10 - 16) * 10, (10 - 12) * 10, 1000, 1],
                               atol=1e-3)


def test_flood_fill_respects_barrier():
    allowed = np.ones((16, 16), bool)
    allowed[:, 8] = False  # wall
    seed = np.zeros((16, 16), bool)
    seed[2, 2] = True
    out = np.asarray(flood_fill(jnp.asarray(seed), jnp.asarray(allowed)))
    assert out[:, :8].sum() == 16 * 8
    assert out[:, 9:].sum() == 0


def test_segment_frame_finds_foreground(rng):
    H, W = 64, 80
    bg = rng.uniform(80, 120, (H, W, 3)).astype(np.float32)
    img = bg.copy()
    img[20:44, 30:54] = rng.uniform(180, 250, (24, 24, 3))
    mask = segment_frame(img, bg, threshold=0.4)
    inside = mask[26:38, 36:48]
    outside_l = mask[:, :20]
    assert (inside > 0).mean() > 0.8
    assert (outside_l > 0).mean() < 0.1


def test_checkpoint_store_roundtrip(tmp_path):
    s = StageStore(str(tmp_path))
    s.save("pair_cloud", 2, xyz=np.ones((5, 3)), col=np.zeros((5, 3)))
    assert s.has("pair_cloud", 2)
    out = s.load("pair_cloud", 2)
    np.testing.assert_array_equal(out["xyz"], np.ones((5, 3)))
    assert s.load("pair_cloud", 3) is None


def _icosphere():
    from reconstruction_tpu.surface.marching import marching_tetrahedra
    R = 32
    g = np.arange(R) - (R - 1) / 2
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 10.0
    return marching_tetrahedra(sdf, 0.0)


def test_decimate_mesh():
    v, f = _icosphere()
    v2, f2 = decimate_mesh(v, f, target_faces=len(f) // 4)
    assert len(f2) <= len(f) // 4
    # still a sphere-ish shell
    c = np.array([15.5] * 3)
    r = np.linalg.norm(v2 - c, axis=1)
    assert abs(np.median(r) - 10.0) < 1.0


def test_loop_subdivide():
    v, f = _icosphere()
    v2, f2 = loop_subdivide(v, f, 1)
    assert len(f2) == 4 * len(f)
    c = np.array([15.5] * 3)
    r = np.linalg.norm(v2 - c, axis=1)
    # subdivision smooths slightly inward but stays a sphere
    assert r.std() < 0.5
    assert abs(np.median(r) - 10.0) < 0.5


def test_watchdog_deadline():
    import time
    assert run_with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(StageTimeout):
        run_with_deadline(lambda: time.sleep(3), 0.3, "sleepy")
    with pytest.raises(FloatingPointError):
        check_finite("stage", np.array([1.0, np.nan]))


def test_roofline_model():
    kind = "NVIDIA H100 80GB HBM3"
    peaks = DEVICE_PEAKS[kind]
    c = ncc_sweep_cost(1920, 1280, 3, 2, 300)
    u = c.utilization(1.0, kind)
    assert u["gflops_per_s"] > 0
    assert u["bound"] in ("hbm", "flops")
    # Unique-byte model: utilization is <= 1 by construction for ANY time
    # at or above the model's own bound (the larger of bytes over peak
    # bandwidth and flops over the f32 peak), and reaches 1 on that
    # bound's side exactly there.
    c64 = ncc_sweep_cost(1920, 1280, 3, 2, 64)
    bound_s = max(c64.hbm_bytes / peaks["hbm_bytes_per_s"],
                  c64.flops / peaks["flops_f32"])
    u64 = c64.utilization(bound_s, kind)
    assert u64["hbm_util"] <= 1.0 + 1e-9 and u64["flops_util"] <= 1.0 + 1e-9
    assert max(u64["hbm_util"], u64["flops_util"]) == pytest.approx(1.0)
    slower = c64.utilization(bound_s * 4.0, kind)
    assert max(slower["hbm_util"], slower["flops_util"]) == \
        pytest.approx(0.25)
    # the refine model counts its build sweep plus per-sweep traffic
    r30 = refine_cost(1920, 1280, 30, build_shifts=40)
    r60 = refine_cost(1920, 1280, 60, build_shifts=40)
    assert r60.hbm_bytes - r30.hbm_bytes == pytest.approx(
        30 * 1920 * 1280 * 4.0 * 34)


def test_point_to_mesh_distance():
    from reconstruction_tpu.utils.metrics import (
        chamfer_distance, point_to_mesh_distance, point_to_mesh_rmse)
    # unit square split into two triangles in z=0 plane
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    pts = np.array([
        [0.5, 0.5, 0.3],    # above interior -> 0.3
        [0.5, 0.5, 0.0],    # on surface -> 0
        [2.0, 0.5, 0.0],    # right of edge x=1 -> 1.0
        [-1.0, -1.0, 0.0],  # beyond corner -> sqrt(2)
        [0.5, 0.5, -0.25],  # below -> 0.25
    ], np.float32)
    d = point_to_mesh_distance(pts, verts, faces)
    np.testing.assert_allclose(d, [0.3, 0.0, 1.0, np.sqrt(2), 0.25],
                               atol=1e-5)
    assert point_to_mesh_rmse(pts, verts, faces) > 0
    rng2 = np.random.default_rng(0)
    a = rng2.normal(size=(100, 3)).astype(np.float32)
    assert chamfer_distance(a, a) < 1e-6

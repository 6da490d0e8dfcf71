"""CPU tests of chip_smoke.py's pieces and of the device-facing rules it
relies on: the device gate, the result line, the peaks table, the
compile-cache rule, the pinned contraction precision, the cloud backend
default, the native-library gate, and the stage-agreement helper (CPU
device vs CPU device)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from reconstruction_tpu.config import NOMATCH, preset
from reconstruction_tpu.utils import compile_cache
from reconstruction_tpu.utils.profiling import DEVICE_PEAKS, device_peaks

H100 = "NVIDIA H100 80GB HBM3"


def test_device_gate_raises_on_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_gate()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line("gpu", H100, count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    f'"{H100}", "count": {count}}}}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": H100, "count": count}}
    assert "\n" not in line


class _FakeDevice:
    platform = "gpu"

    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("kind,known", [
    (H100, True),
    ("NVIDIA H200", False),
    ("cpu", False),
])
def test_peaks_table(kind, known):
    dev = jax.devices("cpu")[0] if kind == "cpu" else _FakeDevice(kind)
    if known:
        got_kind, peaks = device_peaks(dev)
        assert got_kind == kind and peaks is DEVICE_PEAKS[kind]
        assert peaks["hbm_bytes_per_s"] == 3.35e12
        assert peaks["flops_f32"] == 67e12
        assert peaks["flops_bf16"] == 989e12
    else:
        with pytest.raises(KeyError, match="no published peaks"):
            device_peaks(dev)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, env_set):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.default_cache_dir() is None
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []  # nothing set in code
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = f"{compile_cache.CHECKOUT}/.jax_cache"
        assert compile_cache.default_cache_dir() == want
        assert compile_cache.enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
        assert compile_cache.CHECKOUT == chip_smoke.REPO


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a (closed) jaxpr,
    nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
                elif hasattr(sub, "jaxpr"):
                    out += _dot_precisions(sub.jaxpr)
    return out


def _triangulate():
    from reconstruction_tpu.stereo.margins import Margins
    from reconstruction_tpu.stereo.triangulate import disparity_to_cloud
    H, W = 24, 32
    m = Margins(*[jnp.int32(v) for v in (2, H - 3, 2, W - 3)])
    return jax.make_jaxpr(lambda d: disparity_to_cloud(
        d, jnp.full((H, W), 255.0), jnp.zeros((H, W, 3)), np.eye(4),
        np.eye(3), np.zeros(3), m, 1.0))(jnp.zeros((H, W)))


def _normals():
    from reconstruction_tpu.cloud.normals import _cov_stat
    c, k = 8, 16
    return jax.make_jaxpr(_cov_stat)(
        jnp.zeros((c, 3)), jnp.zeros((c, k), jnp.int32),
        jnp.zeros((c, k, 3)), jnp.zeros((c, k)), jnp.ones((c, k), bool))


def _mls():
    from reconstruction_tpu.cloud.mls import _plane_stat
    c, k = 8, 16
    return jax.make_jaxpr(_plane_stat(0.1))(
        jnp.zeros((c, 3)), jnp.zeros((c, k), jnp.int32),
        jnp.zeros((c, k, 3)), jnp.zeros((c, k)), jnp.ones((c, k), bool))


def _texture():
    from reconstruction_tpu.surface.texture import project_vertices
    return jax.make_jaxpr(project_vertices)(jnp.zeros((3, 4)),
                                            jnp.zeros((10, 3)))


def _camera():
    from reconstruction_tpu.core.camera import Camera
    cam = Camera(K=jnp.eye(3), Rt=jnp.zeros((3, 4)))
    return jax.make_jaxpr(lambda c, p: (c.project(p), c.center, c.P))(
        cam, jnp.zeros((5, 3)))


@pytest.mark.parametrize("make", [_triangulate, _normals, _mls, _texture,
                                  _camera],
                         ids=["triangulate", "normals", "mls", "texture",
                              "camera"])
def test_geometry_contractions_pin_highest(make):
    precs = _dot_precisions(make().jaxpr)
    assert precs, "no contraction found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p in ((hi, hi), hi), p


def test_cloud_backend_auto_is_jax(monkeypatch):
    from reconstruction_tpu.cloud.backend import resolve_backend
    monkeypatch.delenv("RECON_CLOUD_BACKEND", raising=False)
    assert resolve_backend("auto") == "jax"
    assert resolve_backend() == "jax"


def _tiny_pair():
    from synthetic import make_stereo_scene
    from reconstruction_tpu.pipeline.reconstruct import PairInput
    cfg = preset("tiny").replace(pyramid_levels=2,
                                 lowest_level_size=(80, 60))
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120),
                                          span_deg=24.0, num_cameras=2)
    return cfg, PairInput(
        image0=imgs[0], image1=imgs[1], mask0=masks[0], mask1=masks[1],
        K0=np.asarray(cams[0].K), Rt0=np.asarray(cams[0].Rt),
        K1=np.asarray(cams[1].K), Rt1=np.asarray(cams[1].Rt))


def test_parallel_render_matches_serial():
    """bench.build_rig renders row bands of the views in worker
    processes; the pixels must equal the serial render's."""
    from synthetic import make_stereo_scene
    _, imgs, masks = make_stereo_scene(image_size=(40, 30), num_cameras=2)
    _, imgs_p, masks_p = make_stereo_scene(image_size=(40, 30),
                                           num_cameras=2, processes=3)
    for a, b in zip(imgs + masks, imgs_p + masks_p):
        np.testing.assert_array_equal(a, b)


def test_stage_agreement_cpu_vs_cpu(cpu_devices):
    """Two CPU devices: the production level program on one and its two
    halves on the other agree on every stage, and each level reports its
    refine noise floor and the bound taken from it."""
    cfg, pin = _tiny_pair()
    out = chip_smoke.stage_agreement(cfg, pin, cpu_devices[0],
                                     cpu_devices[1], report=lambda m: None)
    assert set(out) == {"level0", "level1", "triangulate"}
    for name, m in out.items():
        assert chip_smoke.check(m, {"refine_p99_abs": m.get(
            "refine_p99_limit", 0.05)}) == [], name
    for level, finest in (("level0", False), ("level1", True)):
        m = out[level]
        assert m["int_equal_frac"] == 1.0 and m["valid_agree_frac"] == 1.0
        assert m["refine_p99_abs"] < 1e-4
        assert np.isfinite(m["refine_noise_p99"])
        assert m["refine_noise_p99"] >= 0.0
        assert m["refine_p99_limit"] == chip_smoke.refine_limit(
            m["refine_noise_p99"], finest)
    assert out["level1"]["production_equal"]
    assert out["triangulate"]["xyz_max_rel"] == 0.0


@pytest.mark.parametrize("noise,finest,want", [
    (0.0, False, 0.05),     # quiet coarse level: the stated bound
    (0.01, False, 0.05),
    (0.1, False, 0.3),      # noisy coarse level: NOISE_FACTOR x noise
    (0.1, True, 0.05),      # the finest level keeps the stated bound
])
def test_refine_limit(noise, finest, want):
    assert chip_smoke.refine_limit(noise, finest) == pytest.approx(want)
    m = {"refine_p99_abs": want * 1.01}
    assert chip_smoke.check(m, {"refine_p99_abs": want})
    assert not chip_smoke.check({"refine_p99_abs": want * 0.99},
                                {"refine_p99_abs": want})


def test_native_gate(monkeypatch):
    """The smoke fails when the native host library did not load."""
    from reconstruction_tpu import native
    assert chip_smoke.native_gate() == native.threads() >= 1
    monkeypatch.setattr(native, "threads", lambda: 0)
    with pytest.raises(RuntimeError, match="did not build or load"):
        chip_smoke.native_gate()


def _disparities(rng, H=40, W=50):
    d = rng.integers(0, 30, (H, W)).astype(np.float32)
    d[rng.uniform(size=(H, W)) < 0.2] = NOMATCH
    return d


def _perturb(rng, d, frac, fn):
    d = d.copy()
    sel = (d != NOMATCH) & (rng.uniform(size=d.shape) < frac)
    d[sel] = fn(d[sel])
    return d


@pytest.mark.parametrize("stage", ["integer", "validity", "refine", "xyz",
                                   "chi", "sharded"])
def test_stage_agreement_rejects_perturbed(rng, stage):
    """Each stage's comparison passes on equal inputs and fails when the
    tested side is perturbed past its stated tolerance."""
    from reconstruction_tpu.stereo.triangulate import PointCloud
    d = _disparities(rng)
    pair = (d, d.copy())
    ref = (d + 0.25, d.copy() + 0.25)
    if stage in ("integer", "validity", "refine"):
        same = chip_smoke.compare_level(pair, pair, ref, ref)
        if stage == "integer":
            bad = chip_smoke.compare_level(
                pair, (_perturb(rng, d, 0.01, lambda v: v + 1), d),
                ref, ref)
        elif stage == "validity":
            bad = chip_smoke.compare_level(
                pair, (d, _perturb(rng, d, 0.01, lambda v: NOMATCH)),
                ref, ref)
        else:
            bad = chip_smoke.compare_level(
                pair, pair, ref,
                (_perturb(rng, ref[0], 0.02, lambda v: v + 0.1), ref[1]))
    elif stage == "xyz":
        xyz = rng.uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
        valid = np.ones(500, bool)
        cloud = PointCloud(xyz=xyz, colors=None, valid=valid)
        same = chip_smoke.compare_cloud(cloud, cloud)
        moved = xyz.copy()
        moved[7, 2] += 3e-3  # 1e-3 of the ~3-unit extent
        bad = chip_smoke.compare_cloud(
            cloud, PointCloud(xyz=moved, colors=None, valid=valid))
    elif stage == "chi":
        chi = rng.normal(size=(16, 16, 16)).astype(np.float32)
        same = chip_smoke.compare_chi(chi, chi)
        bad = chip_smoke.compare_chi(chi * (1 + 1e-3), chi)
    else:
        v = d != NOMATCH
        same = chip_smoke.compare_sharded(d, d + 1e-6, v, v)
        assert chip_smoke.check_sharded(same) == []
        # one validity flip fails, in the disparity and in the cloud mask
        flipped = d.copy()
        flipped[np.argwhere(v)[0][0], np.argwhere(v)[0][1]] = NOMATCH
        bad = chip_smoke.compare_sharded(d, flipped, v, v)
        assert chip_smoke.check_sharded(bad), bad
        bad = chip_smoke.compare_sharded(d, d, v, flipped != NOMATCH)
        assert chip_smoke.check_sharded(bad) == ["cloud_valid_equal"]
        bad = chip_smoke.compare_sharded(
            d, _perturb(rng, d, 0.05, lambda x: x + 0.5), v, v)
        assert chip_smoke.check_sharded(bad), bad
        return
    assert chip_smoke.check(same) == []
    assert chip_smoke.check(bad), bad


@pytest.mark.gpu
def test_stage_agreement_gpu_vs_cpu(gpu_device):
    """Card-side: the stage agreement of chip_smoke.py at a small size."""
    cfg, pin = _tiny_pair()
    out = chip_smoke.stage_agreement(cfg, pin, gpu_device,
                                     jax.devices("cpu")[0],
                                     report=lambda m: None)
    for m in out.values():
        assert chip_smoke.check(m, {"refine_p99_abs": m.get(
            "refine_p99_limit", 0.05)}) == []

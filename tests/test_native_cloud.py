"""Native (multi-threaded C++) cloud-stage backend vs the jax path and brute
force.  The native path (native/src/cloud_stats.cpp) is the explicit
"native" cloud backend (cloud/backend.py), so its statistics must agree
with the device formulations."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from reconstruction_tpu import native


@pytest.fixture(autouse=True, scope="module")
def _native_built():
    """The library builds from source at first use; decided here, not
    at import, so every test worker collects the same tests."""
    if not native.available():
        pytest.skip("librecon_native could not be built on this host")


@pytest.mark.parametrize("openmp", [True, False])
def test_native_builds_from_clean_copy(tmp_path, openmp):
    """A copy holding only the Makefile and the sources builds, also
    with several processes asking at once (the lock + rename keeps each
    from loading a half-written library), and with a compiler that has
    no OpenMP runtime (no libgomp: `-fopenmp` fails), which builds the
    same multi-threaded library since the loops run on std::thread."""
    src = os.path.dirname(native.__file__)
    lib_dir = tmp_path / "native"
    lib_dir.mkdir()
    shutil.copy(os.path.join(src, "Makefile"), lib_dir)
    shutil.copytree(os.path.join(src, "src"), lib_dir / "src")
    env = dict(os.environ)
    if not openmp:
        cxx = tmp_path / "cxx-without-openmp"
        cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] '
                       '&& { echo "no OpenMP" >&2; exit 1; }; done\n'
                       'exec g++ "$@"\n')
        cxx.chmod(0o755)
        env["CXX"] = str(cxx)
    code = ("import ctypes, sys; from reconstruction_tpu import native; "
            "p = native.build(sys.argv[1]); "
            "assert ctypes.CDLL(p).native_threads() >= 1; print(p)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(lib_dir)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0, 0], outs
    lib = str(lib_dir / native.LIB_NAME)
    assert outs == [lib] * 4
    assert sorted(os.listdir(lib_dir)) == sorted(
        [".build.lock", "Makefile", native.LIB_NAME, "src"])


def _surface_cloud(rng, n=3000, noise=0.0):
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.1 * (xy[:, 0] ** 2 + xy[:, 1] ** 2)
    pts = np.column_stack([xy, z + rng.normal(scale=noise, size=n)])
    return pts.astype(np.float32)


def test_native_sor_stats_exact(rng):
    """cloud_sor_stats is EXACT mean-of-kNN within the radius bound
    (+ sqrt(k/m) truncation correction) — tighter than the histogram."""
    pts = _surface_cloud(rng, 2000, noise=0.003)
    valid = np.ones(len(pts), bool)
    k = 20
    cell = 0.25
    mean_d, has = native.cloud_sor_stats(pts, valid, cell, k)

    D2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(D2, np.inf)
    for i in range(0, len(pts), 41):
        d = np.sqrt(np.sort(D2[i]))
        d = d[d <= cell]
        if len(d) == 0:
            assert not has[i]
            continue
        m = min(len(d), k)
        want = d[:m].mean() * np.sqrt(k / m)
        assert has[i]
        np.testing.assert_allclose(mean_d[i], want, rtol=2e-4)


def test_native_sor_filter_behaves(rng):
    from reconstruction_tpu.cloud.filters import sor_filter
    pts = _surface_cloud(rng, 4000, noise=0.005)
    outliers = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    outliers[:, 2] += 5.0
    allp = np.vstack([pts, outliers])
    valid = np.ones(len(allp), bool)
    keep = sor_filter(allp, valid, mean_k=30, std_thresh=1.0,
                      backend="native")
    assert isinstance(keep, np.ndarray)  # zero device traffic
    assert keep[:4000].mean() > 0.9
    assert keep[4000:].mean() < 0.2


def test_native_normals_match_jax(rng):
    from reconstruction_tpu.cloud.normals import estimate_normals
    pts = _surface_cloud(rng, 3000, noise=0.002)
    valid = np.ones(len(pts), bool)
    vp = np.array([0.0, 0.0, 100.0], np.float32)
    n_nat = estimate_normals(pts, valid, radius=0.3, viewpoint=vp,
                             backend="native")
    n_jax = np.asarray(estimate_normals(jnp.asarray(pts),
                                        jnp.asarray(valid), radius=0.3,
                                        viewpoint=jnp.asarray(vp),
                                        chunk=512, per_cell=64,
                                        backend="jax"))
    cos = np.abs((n_nat * n_jax).sum(1))
    # per_cell-capped jax candidates vs exact native: directions agree
    assert (cos > 0.995).mean() > 0.97, (cos.mean(), (cos > 0.995).mean())
    assert (n_nat[:, 2] > 0).all()  # flipped toward viewpoint


def test_native_mls_matches_jax(rng):
    from reconstruction_tpu.cloud.mls import mls_smooth
    from reconstruction_tpu.cloud.normals import estimate_normals
    pts = _surface_cloud(rng, 3000, noise=0.01)
    valid = np.ones(len(pts), bool)
    vp = np.array([0.0, 0.0, 100.0], np.float32)
    n0 = estimate_normals(pts, valid, radius=0.3, viewpoint=vp,
                          backend="native")
    sm_nat, nn_nat, ok_nat = mls_smooth(pts, valid, 0.3, n0,
                                        backend="native")
    sm_jax, nn_jax, ok_jax = mls_smooth(jnp.asarray(pts),
                                        jnp.asarray(valid), 0.3,
                                        jnp.asarray(n0), chunk=512,
                                        per_cell=64, backend="jax")
    sm_jax = np.asarray(sm_jax)
    both = ok_nat & np.asarray(ok_jax)
    assert both.mean() > 0.95
    # projected positions agree to a fraction of the noise scale
    err = np.linalg.norm(sm_nat[both] - sm_jax[both], axis=1)
    assert np.median(err) < 2e-3, np.median(err)


def test_backend_resolution(monkeypatch):
    from reconstruction_tpu.cloud.backend import resolve_backend
    assert resolve_backend("jax") == "jax"
    assert resolve_backend("native") == "native"
    monkeypatch.setenv("RECON_CLOUD_BACKEND", "native")
    assert resolve_backend("auto") == "native"
    monkeypatch.delenv("RECON_CLOUD_BACKEND")
    # tests pin the cpu platform -> auto resolves to jax
    assert resolve_backend("auto") == "jax"


def test_texture_np_matches_jax(rng):
    """Host texture blend == device blend (same taps, weights, fills)."""
    from reconstruction_tpu.surface.texture import (texture_vertices,
                                                    texture_vertices_np)
    V = 500
    verts = rng.uniform(-1, 1, (V, 3)).astype(np.float32)
    normals = rng.normal(size=(V, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    cams = []
    for k in range(3):
        K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]])
        R = np.eye(3)
        t = np.array([0.0, 0, 4.0 + k])
        P = (K @ np.hstack([R, t[:, None]])).astype(np.float32)
        img = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
        mask = (rng.uniform(size=(64, 64)) > 0.3).astype(np.float32) * 255
        cams.append((P, img, mask, -R.T @ t))
    a = texture_vertices(verts, normals, cams, backend="jax")
    b = texture_vertices_np(verts, normals, cams)
    np.testing.assert_allclose(a, b, atol=2e-2)


def test_remap_native_matches_jax(rng):
    from reconstruction_tpu.core.remap import remap_bilinear
    img = rng.uniform(0, 255, (37, 53, 3)).astype(np.float32)
    mx = rng.uniform(-3, 56, (21, 31)).astype(np.float32)
    my = rng.uniform(-3, 40, (21, 31)).astype(np.float32)
    a = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                  jnp.asarray(my)))
    b = native.remap_bilinear(img, mx, my)
    np.testing.assert_allclose(a, b, atol=1e-3)
    # 2-D (mask) variant
    a2 = np.asarray(remap_bilinear(jnp.asarray(img[..., 0]),
                                   jnp.asarray(mx), jnp.asarray(my)))
    b2 = native.remap_bilinear(img[..., 0], mx, my)
    np.testing.assert_allclose(a2, b2, atol=1e-3)


def test_fetch_packed_roundtrip(rng):
    from reconstruction_tpu.utils.transfer import fetch_packed
    arrs = [jnp.asarray(rng.normal(size=(7, 5)).astype(np.float32)),
            jnp.asarray(rng.integers(0, 255, (4, 3)).astype(np.uint8)),
            jnp.asarray(rng.uniform(size=11) > 0.5),
            np.arange(4),  # numpy passthrough
            jnp.asarray(rng.integers(-5, 5, (2, 2)).astype(np.int32))]
    out = fetch_packed(arrs)
    for a, o in zip(arrs, out):
        np.testing.assert_array_equal(np.asarray(a), o)
        assert np.asarray(a).dtype == o.dtype


def test_laplacian_native_matches_numpy(rng):
    from reconstruction_tpu.surface import mesh as M
    import reconstruction_tpu.native as nat
    n = 30
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      rng.normal(0, 0.1, n * n)], -1).astype(np.float64)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    faces = np.asarray(faces, np.int32)
    v_nat = M.laplacian_smooth(verts, faces, iterations=5, cotangent=True)
    orig = nat.laplacian_cotan
    try:
        nat.laplacian_cotan = lambda *a, **k: None  # force numpy path
        v_np = M.laplacian_smooth(verts, faces, iterations=5,
                                  cotangent=True)
    finally:
        nat.laplacian_cotan = orig
    np.testing.assert_allclose(v_nat, v_np, atol=1e-9)


def test_host_triangulation_matches_device(rng):
    """disparity_to_cloud_np == the jitted disparity_to_cloud (same f32
    math, same ellipse erosion semantics) — the native backend
    triangulates on host from the fetched disparity."""
    from reconstruction_tpu.stereo.triangulate import (disparity_to_cloud,
                                                       disparity_to_cloud_np)
    from reconstruction_tpu.stereo.margins import Margins
    from reconstruction_tpu.config import NOMATCH

    H, W = 60, 80
    disp = rng.uniform(-10, 40, (H, W)).astype(np.float32)
    disp[rng.uniform(size=(H, W)) < 0.2] = NOMATCH
    mask = (rng.uniform(size=(H, W)) > 0.15).astype(np.float32) * 255
    img = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    Q = np.array([[1, 0, 0, -40.0], [0, 1, 0, -30.0],
                  [0, 0, 0, 100.0], [0, 0, -0.5, 2.0]])
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T = rng.normal(size=3)
    m = Margins(YL=jnp.int32(3), YR=jnp.int32(H - 4),
                XL=jnp.int32(2), XR=jnp.int32(W - 3))

    dev = disparity_to_cloud(jnp.asarray(disp), jnp.asarray(mask),
                             jnp.asarray(img), Q, R, T, m, 0.5,
                             erode_frac=0.02)
    host = disparity_to_cloud_np(disp, mask, np.clip(img, 0, 255)
                                 .astype(np.uint8), Q, R, T,
                                 np.array([3, H - 4, 2, W - 3]), 0.5,
                                 erode_frac=0.02)
    np.testing.assert_array_equal(np.asarray(dev.valid), host.valid)
    np.testing.assert_array_equal(np.asarray(dev.colors), host.colors)
    v = host.valid
    np.testing.assert_allclose(np.asarray(dev.xyz)[v], host.xyz[v],
                               rtol=2e-5, atol=2e-5)


def test_sor_gate_np_matches_jax(rng):
    """_sor_gate_np is the numpy twin of the jitted _sor_gate (same
    imputation for zero-neighbor points, same mu/sigma formula)."""
    from reconstruction_tpu.cloud.filters import _sor_gate, _sor_gate_np
    n = 5000
    mean_d = rng.gamma(2.0, 0.01, n).astype(np.float32)
    has = rng.uniform(size=n) > 0.05
    valid = rng.uniform(size=n) > 0.1
    cell, thresh = 0.05, 1.0
    a = np.asarray(_sor_gate(jnp.asarray(mean_d), jnp.asarray(has),
                             jnp.asarray(valid), jnp.float32(cell),
                             jnp.float32(thresh)))
    b = _sor_gate_np(mean_d, has, valid, cell, thresh)
    # f32-vs-f64 accumulation can flip points sitting exactly on the
    # gate; the populations must agree essentially everywhere
    assert (a == b).mean() > 0.999, (a != b).sum()


def test_match_pair_native_matches_jax():
    """The native per-pair path (host remap + HOST mask erode + bitpacked
    mask upload + host triangulation, r5) against the all-device jax
    path.  The host erode is an exact twin (test_erode_* in test_core),
    so any disparity difference comes only from the remap backend's
    float rounding on the uint8 grid."""
    import sys
    sys.path.insert(0, "tests")
    from synthetic import make_stereo_scene
    from reconstruction_tpu.config import preset
    from reconstruction_tpu.stereo.pipeline import match_pair

    cfg = preset("tiny").replace(
        pyramid_levels=2, lowest_level_size=(80, 60),
        cam_pairs=((0, 1),))
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120),
                                          num_cameras=2)
    args = (imgs[0], imgs[1], masks[0], masks[1],
            np.asarray(cams[0].K), np.asarray(cams[0].Rt),
            np.asarray(cams[1].K), np.asarray(cams[1].Rt))
    r_jax = match_pair(cfg.replace(cloud=cfg.cloud.__class__(
        **{**cfg.cloud.__dict__, "backend": "jax"})), *args)
    r_nat = match_pair(cfg.replace(cloud=cfg.cloud.__class__(
        **{**cfg.cloud.__dict__, "backend": "native"})), *args)

    d_j = np.asarray(r_jax.disparity)
    d_n = np.asarray(r_nat.disparity)
    from reconstruction_tpu.config import NOMATCH
    vj, vn = d_j != NOMATCH, d_n != NOMATCH
    # remap rounding can flip isolated mask/match pixels
    assert (vj != vn).mean() < 0.02, (vj != vn).mean()
    both = vj & vn
    # int16 disparity quantization + remap rounding
    diff = np.abs(d_j[both] - d_n[both])
    assert np.median(diff) < 0.01, np.median(diff)
    assert (diff > 0.5).mean() < 0.01
    assert r_nat.cloud.xyz.shape[0] > 500
    assert np.isfinite(r_nat.cloud.xyz).all()
    # the native rect images feed texture: uint8, same shape
    assert r_nat.rect_images[0].dtype == np.uint8

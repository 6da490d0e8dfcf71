"""Cloud-layer tests: neighbor search vs brute force, SOR, normals, MLS."""

import numpy as np
import jax.numpy as jnp

from reconstruction_tpu.cloud.neighbors import build_grid, gather_neighbors
from reconstruction_tpu.cloud.filters import sor_filter
from reconstruction_tpu.cloud.normals import (
    estimate_normals, smallest_eigenvector_3x3)
from reconstruction_tpu.cloud.mls import mls_smooth


def _surface_cloud(rng, n=3000, noise=0.0):
    """Points on a paraboloid z = 0.1(x^2+y^2) with optional noise."""
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.1 * (xy[:, 0] ** 2 + xy[:, 1] ** 2)
    pts = np.column_stack([xy, z + rng.normal(scale=noise, size=n)])
    return pts.astype(np.float32)


def test_gather_neighbors_vs_bruteforce(rng):
    pts = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    valid = np.ones(500, bool)
    radius = 0.25
    grid = build_grid(jnp.asarray(pts), jnp.asarray(valid), jnp.float32(radius))
    nb = gather_neighbors(grid, jnp.asarray(pts), jnp.asarray(valid),
                          radius=radius, per_cell=32, chunk=128,
                          exclude_self=True)
    ok = np.asarray(nb.ok)
    idx = np.asarray(nb.idx)
    d2 = pts[:, None, :] - pts[None, :, :]
    D2 = (d2 ** 2).sum(-1)
    for i in range(0, 500, 37):
        want = set(np.nonzero((D2[i] <= radius ** 2))[0]) - {i}
        got = set(idx[i][ok[i]].tolist())
        assert got == want, (i, got ^ want)


def test_eigen3x3_matches_numpy(rng):
    for _ in range(50):
        M = rng.normal(size=(3, 3))
        A = (M @ M.T).astype(np.float32)
        lam, v = smallest_eigenvector_3x3(jnp.asarray(A)[None])
        w_np, v_np = np.linalg.eigh(A)
        np.testing.assert_allclose(float(lam[0]), w_np[0],
                                   atol=1e-3 * max(1, abs(w_np).max()))
        cosang = abs(float(np.dot(np.asarray(v)[0], v_np[:, 0])))
        assert cosang > 0.999, cosang


def test_sor_removes_outliers(rng):
    pts = _surface_cloud(rng, 4000, noise=0.005)
    outliers = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    outliers[:, 2] += 5.0  # far off the surface
    allp = np.vstack([pts, outliers])
    valid = np.ones(len(allp), bool)
    keep = np.asarray(sor_filter(jnp.asarray(allp), jnp.asarray(valid),
                                 mean_k=30, std_thresh=1.0, chunk=512))
    # most outliers killed, most surface kept
    assert keep[:4000].mean() > 0.9
    assert keep[4000:].mean() < 0.2


def test_radius_outlier_filter_jax_vs_np_vs_brute(rng):
    """Device and host radius-outlier twins match the brute-force count
    gate (`RadiusOutlierRemoval`, `CCloudOptimization.cpp:90-96`)."""
    from reconstruction_tpu.cloud.filters import (
        radius_outlier_filter, radius_outlier_filter_np)
    pts = rng.uniform(-1, 1, size=(600, 3)).astype(np.float32)
    valid = np.ones(600, bool)
    valid[::17] = False
    radius, min_nb = 0.3, 8
    D2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    inr = (D2 <= radius ** 2) & valid[None, :]
    counts = inr.sum(1) - valid.astype(int)  # exclude self
    want = valid & (counts >= min_nb)
    got_np = radius_outlier_filter_np(pts, valid, radius, min_nb)
    np.testing.assert_array_equal(got_np, want)
    got_jax = np.asarray(radius_outlier_filter(
        jnp.asarray(pts), jnp.asarray(valid), radius, min_nb,
        per_cell=64, chunk=128))
    np.testing.assert_array_equal(got_jax, want)


def test_knn_stat_matches_bruteforce_mean(rng):
    """The histogram k-NN statistic (filters._knn_stat) tracks the exact
    brute-force mean-of-kNN distance within a few percent — a direct
    accuracy gate so a bins/k change can't silently drift the SOR
    statistic (prior tests only asserted behavioral outlier removal)."""
    from reconstruction_tpu.cloud.filters import _knn_stat, _mean_spacing
    from reconstruction_tpu.cloud.neighbors import (
        build_dense_grid, host_grid_geometry, neighbor_map_dense)

    pts = _surface_cloud(rng, 4000, noise=0.003)
    valid = np.ones(len(pts), bool)
    k = 30
    spacing = _mean_spacing(pts, valid)
    cell = spacing * float(np.sqrt(k)) * 0.6 + 1e-6
    origin, dims, cell = host_grid_geometry(pts, valid, cell)
    grid = build_dense_grid(jnp.asarray(pts), jnp.asarray(valid),
                            origin, cell, dims, pad=32)
    got, has = neighbor_map_dense(
        grid, jnp.asarray(pts), jnp.asarray(valid), cell,
        _knn_stat(k), dims, per_cell=32, chunk=512, exclude_self=True)
    got, has = np.asarray(got), np.asarray(has)

    D2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(D2, np.inf)
    rel = []
    for i in range(0, len(pts), 53):
        # Brute-force statistic under the SAME radius bound + density
        # correction the streamed statistic applies.
        d = np.sqrt(np.sort(D2[i])[: 10 * k])
        d = d[d <= cell]
        if len(d) == 0 or not has[i]:
            continue
        m = min(len(d), k)
        want = d[:m].mean() * np.sqrt(k / m)
        rel.append(abs(got[i] - want) / want)
    rel = np.asarray(rel)
    assert len(rel) > 50
    # histogram bins are narrow: each point within a few percent, the
    # population mean much tighter
    assert rel.max() < 0.06, rel.max()
    assert rel.mean() < 0.02, rel.mean()


def test_normals_on_plane(rng):
    xy = rng.uniform(-1, 1, size=(2000, 2))
    pts = np.column_stack([xy, 0.2 * xy[:, 0] + 0.1 * xy[:, 1]]).astype(np.float32)
    valid = np.ones(2000, bool)
    vp = np.array([0.0, 0.0, 100.0], np.float32)
    n = np.asarray(estimate_normals(jnp.asarray(pts), jnp.asarray(valid),
                                    radius=0.3, viewpoint=jnp.asarray(vp),
                                    chunk=512))
    true_n = np.array([-0.2, -0.1, 1.0])
    true_n /= np.linalg.norm(true_n)
    cos = n @ true_n
    assert (cos > 0.99).mean() > 0.95
    assert (n[:, 2] > 0).all()  # flipped toward viewpoint


def test_mls_denoises(rng):
    pts = _surface_cloud(rng, 4000, noise=0.02)
    valid = np.ones(len(pts), bool)
    vp = jnp.asarray(np.array([0, 0, 100.0], np.float32))
    normals0 = estimate_normals(jnp.asarray(pts), jnp.asarray(valid),
                                radius=0.3, viewpoint=vp, chunk=512)
    sm, n, ok = mls_smooth(jnp.asarray(pts), jnp.asarray(valid), 0.3,
                           normals0, chunk=512)
    sm, ok = np.asarray(sm), np.asarray(ok)
    assert ok.mean() > 0.95
    def resid(p):
        return p[:, 2] - 0.1 * (p[:, 0] ** 2 + p[:, 1] ** 2)
    r_before = np.abs(resid(pts[ok])).mean()
    r_after = np.abs(resid(sm[ok])).mean()
    assert r_after < 0.6 * r_before, (r_before, r_after)


def test_cross_view_dedup_bucket_rules():
    """Unit test of the documented bucket semantics (single kept,
    same-facing duplicates -> nearest kept, opposing normals -> both,
    out-of-mask dropped)."""
    import jax.numpy as jnp
    from reconstruction_tpu.cloud.dedup import DedupInputs, cross_view_dedup

    H, W = 16, 16
    # One pair: cam0 at origin looking down +z, P = K [I | 0].
    K = np.array([[10.0, 0, 8], [0, 10, 8], [0, 0, 1]], np.float32)
    P0 = np.hstack([K, np.zeros((3, 1), np.float32)])[None]

    toward = np.array([0, 0, -1], np.float32)   # faces the camera
    away = np.array([0, 0, 1], np.float32)
    # pixel u = 10 * x / z + 8, v likewise in y.
    pts = np.array([
        [0.0, 0.0, 5.0],    # 0: bucket (8,8), alone -> kept
        [1.0, 0.0, 5.0],    # 1: bucket (10,8), nearest, toward -> kept
        [1.2, 0.0, 6.0],    # 2: bucket (10,8), farther, toward -> dropped
        [0.0, 1.0, 5.0],    # 3: bucket (8,10), toward -> kept
        [0.0, 1.2, 6.0],    # 4: bucket (8,10), away (opposes) -> kept
        [-1.0, 0.0, 5.0],   # 5: bucket (6,8), masked out -> dropped
    ], np.float32)
    nrm = np.stack([toward, toward, toward, toward, away, toward])
    masks = np.ones((1, H, W), np.float32)
    masks[0, 8, 6] = 0.0                        # point 5's pixel
    ctx = DedupInputs(
        P0=jnp.asarray(P0), P1=jnp.asarray(P0),
        centers=jnp.asarray(np.zeros((1, 3), np.float32)),
        masks0=jnp.asarray(masks))

    keep = np.asarray(cross_view_dedup(
        jnp.asarray(pts), jnp.asarray(nrm),
        jnp.asarray(np.ones(len(pts), bool)), ctx))
    assert keep[0]
    assert keep[1] and not keep[2]
    assert keep[3] and keep[4]
    assert not keep[5]


def test_cross_view_dedup_vs_oracle(rng):
    """Property test: the vectorized bucket resolution equals the
    sequential oracle re-expression of `CCloudOptimization.cpp:152-346`
    (with the documented deviations, see oracle.dedup) on random clouds
    observed by multiple camera pairs."""
    from reconstruction_tpu.cloud.dedup import DedupInputs, cross_view_dedup
    import oracle

    H, W = 24, 24
    npair = 3
    K = np.array([[6.0, 0, 12], [0, 6, 12], [0, 0, 1]], np.float32)
    # Cameras on a circle looking at the origin.
    P0s, centers = [], []
    for j in range(npair):
        ang = 2 * np.pi * j / npair
        C = np.array([8 * np.sin(ang), 0.5 * j, 8 * np.cos(ang)], np.float32)
        z = -C / np.linalg.norm(C)                       # look at origin
        x = np.cross(np.array([0, 1, 0], np.float32), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        t = -R @ C
        P0s.append(K @ np.hstack([R, t[:, None]]))
        centers.append(C)
    P0 = np.stack(P0s).astype(np.float32)
    centers = np.stack(centers).astype(np.float32)

    for trial in range(4):
        N = 400
        pts = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
        nrm = rng.normal(size=(N, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        valid = rng.uniform(size=N) > 0.1
        masks = (rng.uniform(size=(npair, H, W)) > 0.2).astype(np.float32)

        ctx = DedupInputs(P0=jnp.asarray(P0), P1=jnp.asarray(P0),
                          centers=jnp.asarray(centers),
                          masks0=jnp.asarray(masks))
        got = np.asarray(cross_view_dedup(
            jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid), ctx))
        want = oracle.dedup(pts.astype(np.float64), nrm.astype(np.float64),
                            valid, P0.astype(np.float64),
                            centers.astype(np.float64), masks)
        assert (got == want).all(), (trial, np.nonzero(got != want))


def test_dense_grid_outlier_bbox_bounded(rng):
    """Regression: a pre-SOR stereo cloud's raw bbox is set by
    triangulation outliers; the dense grid must stay within its cell
    budget (unbounded, it would allocate a billions-of-cells table) and the filter must still kill the
    outliers."""
    from reconstruction_tpu.cloud.filters import sor_filter
    from reconstruction_tpu.cloud.neighbors import host_grid_geometry

    n = 20000
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    pts[:, 2] *= 0.05                       # surface-ish slab
    pts[:5] = [[900.0, -700.0, 5000.0], [-800.0, 600.0, -4000.0],
               [550.0, 910.0, 3000.0], [-640.0, -880.0, 2500.0],
               [990.0, 20.0, -3500.0]]    # wild triangulation outliers
    valid = np.ones(n, bool)

    origin, dims, cell = host_grid_geometry(pts, valid, 0.05,
                                            max_cells=2_000_000)
    assert dims[0] * dims[1] * dims[2] <= 2_000_000, dims
    assert cell >= 0.05

    keep = np.asarray(sor_filter(jnp.asarray(pts), jnp.asarray(valid),
                                 mean_k=20))
    assert not keep[:5].any()               # outliers killed
    assert keep[5:].mean() > 0.9            # surface survives


def test_dedup_nearest_wins_vs_intended_ncc(rng):
    """MEASURE the production simplification (nearest-wins bucket
    representative) against the INTENDED NCC-scored resolution
    (oracle.dedup_ncc; the reference's own scoring degenerates to
    first-eligible-wins because it reads both windows at the same pixel,
    `CCloudOptimization.cpp:254,322`).  On a textured surface observed
    by a camera ring with jittered duplicate points, the two must agree
    on the vast majority of points — the number that justifies shipping
    the simplification."""
    from reconstruction_tpu.cloud.dedup import DedupInputs, cross_view_dedup
    import oracle

    H, W = 32, 32
    npair = 3
    K = np.array([[9.0, 0, 16], [0, 9, 16], [0, 0, 1]], np.float64)
    P0s, P1s, centers = [], [], []
    for j in range(npair):
        ang = 2 * np.pi * j / npair

        def cam(C):
            z = -C / np.linalg.norm(C)
            x = np.cross(np.array([0, 1, 0.0]), z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            R = np.stack([x, y, z])
            return K @ np.hstack([R, (-R @ C)[:, None]])

        C0 = np.array([6 * np.sin(ang), 0.3, 6 * np.cos(ang)])
        C1 = np.array([6 * np.sin(ang + 0.12), 0.5, 6 * np.cos(ang + 0.12)])
        P0s.append(cam(C0))
        P1s.append(cam(C1))
        centers.append(C0)
    P0, P1 = np.stack(P0s), np.stack(P1s)
    centers = np.stack(centers)

    # Textured-ish sphere surface + jittered duplicates (multi-candidate
    # buckets with same facing).
    M = 500
    v = rng.normal(size=(M, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    base = (v * 1.5).astype(np.float64)
    dup = base + rng.normal(0, 0.05, base.shape)
    pts = np.concatenate([base, dup])
    nrm = np.concatenate([v, v]).astype(np.float64)
    valid = np.ones(len(pts), bool)
    masks = np.ones((npair, H, W), np.float32)
    images0 = rng.uniform(0, 255, (npair, H, W, 3))
    images1 = rng.uniform(0, 255, (npair, H, W, 3))

    got = np.asarray(cross_view_dedup(
        jnp.asarray(pts, jnp.float32), jnp.asarray(nrm, jnp.float32),
        jnp.asarray(valid), DedupInputs(
            P0=jnp.asarray(P0, jnp.float32), P1=jnp.asarray(P1, jnp.float32),
            centers=jnp.asarray(centers, jnp.float32),
            masks0=jnp.asarray(masks))))
    want = oracle.dedup_ncc(pts, nrm, valid, P0, P1, centers, masks,
                            images0, images1)
    agree = (got == want).mean()
    # Both keep exactly one representative per same-facing run; they can
    # only differ on WHICH duplicate survives, so disagreement is
    # bounded by the duplicated fraction and measured here.
    assert agree > 0.85, agree
    # kept-population sizes must match closely (same run structure)
    assert abs(got.sum() - want.sum()) <= 0.05 * want.sum(), (
        got.sum(), want.sum())


def test_neighbor_map_dense_split_matches_unsplit(rng, monkeypatch):
    """The crash-shape query splitting (RECON_NEIGHBOR_MAX_QUERIES,
    cloud/neighbors.neighbor_map_dense) must be bit-identical to the
    single-program path — including exclude_self, whose query ids must
    stay GLOBAL across slices (the first cut restarted them per slice
    and silently included every point as its own neighbor)."""
    from reconstruction_tpu.cloud.filters import _knn_stat, _mean_spacing
    from reconstruction_tpu.cloud.neighbors import (
        build_dense_grid, host_grid_geometry, neighbor_map_dense)

    pts = _surface_cloud(rng, 3000, noise=0.003)
    valid = np.ones(len(pts), bool)
    k = 20
    spacing = _mean_spacing(pts, valid)
    cell = spacing * float(np.sqrt(k)) * 0.6 + 1e-6
    origin, dims, cell = host_grid_geometry(pts, valid, cell)
    grid = build_dense_grid(jnp.asarray(pts), jnp.asarray(valid),
                            origin, cell, dims, pad=16)

    def run():
        return neighbor_map_dense(
            grid, jnp.asarray(pts), jnp.asarray(valid), cell,
            _knn_stat(k), dims, per_cell=16, chunk=256,
            exclude_self=True)

    monkeypatch.delenv("RECON_NEIGHBOR_MAX_QUERIES", raising=False)
    md0, has0 = map(np.asarray, run())
    monkeypatch.setenv("RECON_NEIGHBOR_MAX_QUERIES", "700")
    md1, has1 = map(np.asarray, run())
    np.testing.assert_array_equal(has0, has1)
    np.testing.assert_allclose(md0, md1, rtol=0, atol=0)

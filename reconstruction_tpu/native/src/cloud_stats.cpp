// Native (host, multi-threaded) cloud-stage statistics: SOR k-NN mean distance,
// covariance normals, MLS plane fit.  Functional equivalents of the PCL
// stages the reference uses (`CCloudOptimization.cpp:82-121,350-364`)
// and of the JAX voxel-grid formulations in reconstruction_tpu/cloud/
// (same radius bounds, same truncated-k sqrt(k/m) correction, same
// closed-form 3x3 eigen math) — selectable as the cloud backend
// ("native") where host execution is preferred.
//
// Grid: counting-sort voxel grid with 27-cell neighborhoods, exact
// per-point k nearest via nth_element (no per-cell candidate cap, so
// the statistic is closer to PCL's exact KD-tree k-NN than the capped
// device path).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "parallel.h"

namespace {

struct Grid {
    float ox, oy, oz, cell;
    int dx, dy, dz;
    std::vector<int> start;   // G+1 exclusive prefix
    std::vector<int> order;   // point index per sorted slot
    // SoA copies of the sorted coordinates: neighbor scans read these
    // CONTIGUOUSLY (the r3 layout gathered pts[3*order[s]] per
    // candidate — a random 12-byte access that defeated both the cache
    // and the vectorizer; the tail stages spend ~80% of their time in
    // these scans).
    std::vector<float> xs, ys, zs;
};

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Per-axis robust bbox: [q, 1-q] quantiles intersected with the Tukey
// fence [Q25 - 1.5 IQR, Q75 + 1.5 IQR] (mirrors neighbors.robust_bbox).
void robust_bbox(const float* pts, const uint8_t* valid, long n,
                 float lo[3], float hi[3]) {
    std::vector<float> axis;
    axis.reserve(200000);
    long stride = 1;
    long nv = 0;
    for (long i = 0; i < n; ++i) nv += valid[i] != 0;
    if (nv > 200000) stride = nv / 200000 + 1;
    for (int a = 0; a < 3; ++a) {
        axis.clear();
        long seen = 0;
        for (long i = 0; i < n; ++i) {
            if (!valid[i]) continue;
            if ((seen++ % stride) != 0) continue;
            axis.push_back(pts[3 * i + a]);
        }
        if (axis.empty()) { lo[a] = 0.f; hi[a] = 1.f; continue; }
        auto q = [&](double f) {
            size_t k = (size_t)(f * (axis.size() - 1));
            std::nth_element(axis.begin(), axis.begin() + k, axis.end());
            return axis[k];
        };
        float loq = q(0.005), hiq = q(0.995);
        float q25 = q(0.25), q75 = q(0.75);
        float iqr = std::max(q75 - q25, 1e-6f);
        lo[a] = std::max(loq, q25 - 1.5f * iqr);
        hi[a] = std::min(hiq, q75 + 1.5f * iqr);
    }
}

Grid build_grid(const float* pts, const uint8_t* valid, long n, float cell) {
    Grid g;
    float lo[3], hi[3];
    robust_bbox(pts, valid, n, lo, hi);
    const long max_cells = 1L << 24;
    for (;;) {
        long dx = (long)((hi[0] - lo[0]) / cell) + 3;
        long dy = (long)((hi[1] - lo[1]) / cell) + 3;
        long dz = (long)((hi[2] - lo[2]) / cell) + 3;
        if (dx * dy * dz <= max_cells) { g.dx = (int)dx; g.dy = (int)dy; g.dz = (int)dz; break; }
        cell *= 1.5f;
    }
    g.ox = lo[0] - cell; g.oy = lo[1] - cell; g.oz = lo[2] - cell;
    g.cell = cell;
    const long G = (long)g.dx * g.dy * g.dz;
    std::vector<int> ids(n, -1);
    std::vector<int> count(G + 1, 0);
    recon::parallel_for(n, [&](long i) {
        if (!valid[i]) return;
        int cx = clampi((int)((pts[3 * i] - g.ox) / cell), 0, g.dx - 1);
        int cy = clampi((int)((pts[3 * i + 1] - g.oy) / cell), 0, g.dy - 1);
        int cz = clampi((int)((pts[3 * i + 2] - g.oz) / cell), 0, g.dz - 1);
        ids[i] = ((long)cx * g.dy + cy) * g.dz + cz;
    });
    for (long i = 0; i < n; ++i)
        if (ids[i] >= 0) ++count[ids[i]];
    g.start.resize(G + 1);
    long acc = 0;
    for (long c = 0; c < G; ++c) { g.start[c] = (int)acc; acc += count[c]; }
    g.start[G] = (int)acc;
    g.order.resize(acc);
    std::vector<int> cur(G, 0);
    for (long i = 0; i < n; ++i) {
        if (ids[i] < 0) continue;
        long c = ids[i];
        g.order[g.start[c] + cur[c]++] = (int)i;
    }
    g.xs.resize(acc);
    g.ys.resize(acc);
    g.zs.resize(acc);
    recon::parallel_for(acc, [&](long s) {
        const float* p = pts + 3L * g.order[s];
        g.xs[s] = p[0];
        g.ys[s] = p[1];
        g.zs[s] = p[2];
    });
    return g;
}

// Visit all points within the (2*reach+1)^3-cell neighborhood of p.
// reach = ceil(radius / cell): finer cells than the radius scan a
// tighter superset of the search ball — cell = radius/2 (reach 2)
// sweeps (2.5r)^3 of space instead of (3r)^3, ~30% fewer candidates.
//
// Callback signature: f(slot s, dx, dy, dz, d2); the caller recovers
// the point index via g.order[s] when it needs one.  Consecutive
// z-cells are adjacent in the counting-sort layout, so the whole z
// extent of an (x, y) column is ONE contiguous slot range over the SoA
// arrays — a vectorizable stream, not a per-cell pointer chase.
template <typename F>
inline void for_neighbors(const Grid& g, const float*, float px,
                          float py, float pz, int reach, F&& f) {
    int cx = clampi((int)((px - g.ox) / g.cell), 0, g.dx - 1);
    int cy = clampi((int)((py - g.oy) / g.cell), 0, g.dy - 1);
    int cz = clampi((int)((pz - g.oz) / g.cell), 0, g.dz - 1);
    int z0 = std::max(cz - reach, 0), z1 = std::min(cz + reach, g.dz - 1);
    const float* xs = g.xs.data();
    const float* ys = g.ys.data();
    const float* zs = g.zs.data();
    for (int ax = std::max(cx - reach, 0); ax <= std::min(cx + reach, g.dx - 1); ++ax)
        for (int ay = std::max(cy - reach, 0); ay <= std::min(cy + reach, g.dy - 1); ++ay) {
            long row = ((long)ax * g.dy + ay) * g.dz;
            int s0 = g.start[row + z0];
            int s1 = g.start[row + z1 + 1];
            for (int s = s0; s < s1; ++s) {
                float dx = xs[s] - px;
                float dy = ys[s] - py;
                float dz2 = zs[s] - pz;
                f(s, dx, dy, dz2, dx * dx + dy * dy + dz2 * dz2);
            }
        }
}

// Column-range variant of for_neighbors: hands the callback the SoA
// arrays + one contiguous slot range per (x, y) cell column, so the
// callee can run an explicitly vectorized (omp simd) inner loop.
template <typename F>
inline void scan_columns(const Grid& g, float px, float py, float pz,
                         int reach, F&& f) {
    int cx = clampi((int)((px - g.ox) / g.cell), 0, g.dx - 1);
    int cy = clampi((int)((py - g.oy) / g.cell), 0, g.dy - 1);
    int cz = clampi((int)((pz - g.oz) / g.cell), 0, g.dz - 1);
    int z0 = std::max(cz - reach, 0), z1 = std::min(cz + reach, g.dz - 1);
    const float* xs = g.xs.data();
    const float* ys = g.ys.data();
    const float* zs = g.zs.data();
    for (int ax = std::max(cx - reach, 0); ax <= std::min(cx + reach, g.dx - 1); ++ax)
        for (int ay = std::max(cy - reach, 0); ay <= std::min(cy + reach, g.dy - 1); ++ay) {
            long row = ((long)ax * g.dy + ay) * g.dz;
            f(xs, ys, zs, g.start[row + z0], g.start[row + z1 + 1]);
        }
}

// Smallest eigenpair of a symmetric 3x3 (trigonometric method; the
// same math as cloud/normals.smallest_eigenvector_3x3).
void smallest_eigvec(const double A[6], float out[3]) {
    // A packed: xx, xy, xz, yy, yz, zz
    double q = (A[0] + A[3] + A[5]) / 3.0;
    double B[6] = {A[0] - q, A[1], A[2], A[3] - q, A[4], A[5] - q};
    double p2 = (B[0] * B[0] + B[3] * B[3] + B[5] * B[5]
                 + 2 * (B[1] * B[1] + B[2] * B[2] + B[4] * B[4])) / 6.0;
    double lam;
    if (p2 < 1e-20) {
        lam = q;
    } else {
        double p = std::sqrt(p2);
        double detB = B[0] * (B[3] * B[5] - B[4] * B[4])
                    - B[1] * (B[1] * B[5] - B[4] * B[2])
                    + B[2] * (B[1] * B[4] - B[3] * B[2]);
        double r = detB / (2 * p * p * p);
        r = std::max(-1.0, std::min(1.0, r));
        double phi = std::acos(r) / 3.0;
        lam = q + 2 * p * std::cos(phi + 2.0 * M_PI / 3.0);
    }
    double C[3][3] = {{A[0] - lam, A[1], A[2]},
                      {A[1], A[3] - lam, A[4]},
                      {A[2], A[4], A[5] - lam}};
    double best[3] = {0, 0, 1}, bestn = -1;
    int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (auto& pr : pairs) {
        double* r0 = C[pr[0]];
        double* r1 = C[pr[1]];
        double cx = r0[1] * r1[2] - r0[2] * r1[1];
        double cy = r0[2] * r1[0] - r0[0] * r1[2];
        double cz = r0[0] * r1[1] - r0[1] * r1[0];
        double nn = cx * cx + cy * cy + cz * cz;
        if (nn > bestn) { bestn = nn; best[0] = cx; best[1] = cy; best[2] = cz; }
    }
    double nn = std::sqrt(best[0] * best[0] + best[1] * best[1] + best[2] * best[2]);
    if (nn > 1e-20) {
        out[0] = (float)(best[0] / nn);
        out[1] = (float)(best[1] / nn);
        out[2] = (float)(best[2] / nn);
    } else {
        out[0] = 0.f; out[1] = 0.f; out[2] = 1.f;
    }
}

}  // namespace

extern "C" {

// Per-point mean distance to the k nearest neighbors within `cell`
// (exact within the 27-cell neighborhood), with the sqrt(k/m)
// truncated-neighborhood correction.  Outputs mean_d (n) and has (n).
void cloud_sor_stats(const float* pts, const uint8_t* valid, long n,
                     float cell, int k, float* mean_d, uint8_t* has) {
    // SOR's cell is already ~6x the point spacing; finer sub-cells
    // measured SLOWER here (cell-loop overhead), unlike normals/MLS.
    Grid g = build_grid(pts, valid, n, cell);
    const int reach = (int)std::ceil(cell / g.cell);
    const float r2 = cell * cell;
    recon::parallel_ranges(n, 512, [&](long lo, long hi) {
        std::vector<float> d2s;
        d2s.reserve(1024);
        for (long i = lo; i < hi; ++i) {
            mean_d[i] = 0.f;
            has[i] = 0;
            if (!valid[i]) continue;
            d2s.clear();
            for_neighbors(g, pts, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                          reach, [&](int s, float, float, float, float d2) {
                              if (g.order[s] != (int)i && d2 <= r2)
                                  d2s.push_back(d2);
                          });
            if (d2s.empty()) continue;
            size_t m = std::min((size_t)k, d2s.size());
            std::nth_element(d2s.begin(), d2s.begin() + (m - 1), d2s.end());
            double acc = 0;
            for (size_t t = 0; t < m; ++t) acc += std::sqrt((double)d2s[t]);
            mean_d[i] = (float)(acc / m * std::sqrt((double)k / m));
            has[i] = 1;
        }
    });
}

// Covariance normals within `radius`, flipped toward the viewpoint.
// Single neighbor pass: raw moments about the query point (numerically
// safe — offsets are O(radius)), cov = E[xx^T] - mu mu^T.
void cloud_normals(const float* pts, const uint8_t* valid, long n,
                   float radius, const float* viewpoint, float* normals) {
    Grid g = build_grid(pts, valid, n, radius * 0.5f);
    const int reach = (int)std::ceil(radius / g.cell);
    const float r2 = radius * radius;
    recon::parallel_ranges(n, 512, [&](long lo, long hi) {
        for (long i = lo; i < hi; ++i) {
            float* out = normals + 3 * i;
            if (!valid[i]) { out[0] = 0; out[1] = 0; out[2] = 1; continue; }
            float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
            double m1[3] = {0, 0, 0}, m2[6] = {0, 0, 0, 0, 0, 0};
            double cntd = 0;
            // Branch-free SIMD moment scan, one contiguous slot range per
            // (x, y) column (see for_neighbors); float accumulators per
            // column (<= a few hundred small terms), double across columns.
            scan_columns(g, px, py, pz, reach, [&](const float* xs,
                                                   const float* ys,
                                                   const float* zs,
                                                   int s0, int s1) {
                float w_ = 0, a0 = 0, a1 = 0, a2 = 0;
                float b0 = 0, b1 = 0, b2 = 0, b3 = 0, b4 = 0, b5 = 0;
#pragma omp simd reduction(+:w_, a0, a1, a2, b0, b1, b2, b3, b4, b5)
                for (int s = s0; s < s1; ++s) {
                    float dx = xs[s] - px, dy = ys[s] - py, dz = zs[s] - pz;
                    float d2 = dx * dx + dy * dy + dz * dz;
                    float w = d2 <= r2 ? 1.f : 0.f;
                    w_ += w;
                    a0 += w * dx; a1 += w * dy; a2 += w * dz;
                    b0 += w * dx * dx; b1 += w * dx * dy; b2 += w * dx * dz;
                    b3 += w * dy * dy; b4 += w * dy * dz; b5 += w * dz * dz;
                }
                cntd += w_;
                m1[0] += a0; m1[1] += a1; m1[2] += a2;
                m2[0] += b0; m2[1] += b1; m2[2] += b2;
                m2[3] += b3; m2[4] += b4; m2[5] += b5;
            });
            long cnt = (long)(cntd + 0.5);
            if (cnt == 0) { out[0] = 0; out[1] = 0; out[2] = 1; continue; }
            double inv = 1.0 / cnt;
            double mx = m1[0] * inv, my = m1[1] * inv, mz = m1[2] * inv;
            double A[6] = {m2[0] * inv - mx * mx, m2[1] * inv - mx * my,
                           m2[2] * inv - mx * mz, m2[3] * inv - my * my,
                           m2[4] * inv - my * mz, m2[5] * inv - mz * mz};
            smallest_eigvec(A, out);
            float tx = viewpoint[0] - px, ty = viewpoint[1] - py,
                  tz = viewpoint[2] - pz;
            if (out[0] * tx + out[1] * ty + out[2] * tz < 0) {
                out[0] = -out[0]; out[1] = -out[1]; out[2] = -out[2];
            }
        }
    });
}

// MLS: Gaussian-weighted plane fit + projection; normal re-oriented
// against prev_normals.  ok[i] = had any neighbor within radius.
void cloud_mls(const float* pts, const uint8_t* valid, long n,
               float radius, const float* prev_normals,
               float* out_pts, float* out_normals, uint8_t* ok) {
    Grid g = build_grid(pts, valid, n, radius * 0.5f);
    const int reach = (int)std::ceil(radius / g.cell);
    const float r2 = radius * radius;
    const double inv_r2 = 1.0 / ((double)radius * radius);
    recon::parallel_ranges(n, 512, [&](long lo, long hi) {
        for (long i = lo; i < hi; ++i) {
            float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
            out_pts[3 * i] = px; out_pts[3 * i + 1] = py; out_pts[3 * i + 2] = pz;
            out_normals[3 * i] = 0; out_normals[3 * i + 1] = 0;
            out_normals[3 * i + 2] = 1;
            ok[i] = 0;
            if (!valid[i]) continue;
            // Single pass: weighted raw moments about the query point
            // (offsets are O(radius) so E[xx^T] - mu mu^T is stable here).
            double wsum = 0, m1[3] = {0, 0, 0}, m2[6] = {0, 0, 0, 0, 0, 0};
            const float inv_r2f = (float)inv_r2;
            // Branch-free SIMD scan with a polynomial Gaussian: exp(-x) on
            // x in [0, 1] via the degree-6 Taylor tail (max error ~2e-4 —
            // the MLS parity contract vs the jax path is 2e-3 median,
            // test_native_mls_matches_jax, and the plane fit is robust to
            // sub-permille weight perturbations).  A libm expf here costs
            // ~30% of the whole stage at ~300 candidates/point.
            scan_columns(g, px, py, pz, reach, [&](const float* xs,
                                                   const float* ys,
                                                   const float* zs,
                                                   int s0, int s1) {
                float w_ = 0, a0 = 0, a1 = 0, a2 = 0;
                float b0 = 0, b1 = 0, b2 = 0, b3 = 0, b4 = 0, b5 = 0;
#pragma omp simd reduction(+:w_, a0, a1, a2, b0, b1, b2, b3, b4, b5)
                for (int s = s0; s < s1; ++s) {
                    float dx = xs[s] - px, dy = ys[s] - py, dz = zs[s] - pz;
                    float d2 = dx * dx + dy * dy + dz * dz;
                    float x = d2 * inv_r2f;
                    float w = 1.f + x * (-1.f + x * (0.5f + x * (-1.f / 6
                              + x * (1.f / 24 + x * (-1.f / 120
                              + x * (1.f / 720))))));
                    w = d2 <= r2 ? w : 0.f;
                    w_ += w;
                    a0 += w * dx; a1 += w * dy; a2 += w * dz;
                    b0 += w * dx * dx; b1 += w * dx * dy; b2 += w * dx * dz;
                    b3 += w * dy * dy; b4 += w * dy * dz; b5 += w * dz * dz;
                }
                wsum += w_;
                m1[0] += a0; m1[1] += a1; m1[2] += a2;
                m2[0] += b0; m2[1] += b1; m2[2] += b2;
                m2[3] += b3; m2[4] += b4; m2[5] += b5;
            });
            if (wsum <= 0) continue;
            double inv = 1.0 / wsum;
            double ox = m1[0] * inv, oy = m1[1] * inv, oz = m1[2] * inv;
            double mx = px + ox, my = py + oy, mz = pz + oz;
            double A[6] = {m2[0] * inv - ox * ox, m2[1] * inv - ox * oy,
                           m2[2] * inv - ox * oz, m2[3] * inv - oy * oy,
                           m2[4] * inv - oy * oz, m2[5] * inv - oz * oz};
            float nv[3];
            smallest_eigvec(A, nv);
            const float* pn = prev_normals + 3 * i;
            if (nv[0] * pn[0] + nv[1] * pn[1] + nv[2] * pn[2] < 0) {
                nv[0] = -nv[0]; nv[1] = -nv[1]; nv[2] = -nv[2];
            }
            double dist = (px - mx) * nv[0] + (py - my) * nv[1] + (pz - mz) * nv[2];
            out_pts[3 * i] = (float)(px - dist * nv[0]);
            out_pts[3 * i + 1] = (float)(py - dist * nv[1]);
            out_pts[3 * i + 2] = (float)(pz - dist * nv[2]);
            out_normals[3 * i] = nv[0];
            out_normals[3 * i + 1] = nv[1];
            out_normals[3 * i + 2] = nv[2];
            ok[i] = 1;
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host bilinear remap (the rectification warp).  Mirrors
// core/remap.remap_bilinear exactly: 4 taps, BORDER_CONSTANT(fill),
// float32 math.  On host it is memory-bandwidth work, and the rectified
// images are then already host-resident for texturing.
// ---------------------------------------------------------------------------

extern "C" void remap_bilinear_f32(const float* img, long H, long W, long C,
                                   const float* mapx, const float* mapy,
                                   long Ho, long Wo, float fill,
                                   float* out) {
    recon::parallel_for(Ho, [&](long r) {
        for (long c = 0; c < Wo; ++c) {
            float mx = mapx[r * Wo + c];
            float my = mapy[r * Wo + c];
            float x0f = std::floor(mx), y0f = std::floor(my);
            float fx = mx - x0f, fy = my - y0f;
            long x0 = (long)x0f, y0 = (long)y0f;
            float* o = out + (r * Wo + c) * C;
            for (long ch = 0; ch < C; ++ch) {
                auto tap = [&](long yi, long xi) -> float {
                    if (xi < 0 || xi >= W || yi < 0 || yi >= H) return fill;
                    return img[(yi * W + xi) * C + ch];
                };
                float top = tap(y0, x0) * (1.f - fx) + tap(y0, x0 + 1) * fx;
                float bot = tap(y0 + 1, x0) * (1.f - fx)
                          + tap(y0 + 1, x0 + 1) * fx;
                o[ch] = top * (1.f - fy) + bot * fy;
            }
        }
    });
}

// ---------------------------------------------------------------------------
// Cotangent Laplacian smoothing (surface/mesh.laplacian_smooth's inner
// loop): per iteration, edge (j,k) of each face accumulates the cot of
// the opposite angle symmetrically; vertices move toward the weighted
// neighbor average (lam blend), boundary vertices pinned.  The numpy
// formulation allocates ~30 temporaries of 60 MB per iteration; here it
// is one fused pass with per-block accumulators, summed in block order
// (the result does not depend on the thread count's scheduling).
// ---------------------------------------------------------------------------

extern "C" void laplacian_cotan(double* v, long nv, const int32_t* faces,
                                long nf, int iterations, double lam,
                                const uint8_t* is_bnd) {
    std::vector<double> acc((size_t)nv * 3), deg(nv), nxt((size_t)nv * 3);
    const long nblk = std::min<long>(recon::num_threads(), std::max(nf, 1L));
    const long fgrain = (nf + nblk - 1) / nblk;
    std::vector<std::vector<double>> la(nblk), ld(nblk);
    for (int it = 0; it < iterations; ++it) {
        recon::parallel_ranges(nf, fgrain, [&](long lo, long hi) {
            const long b = lo / fgrain;
            std::vector<double>& a3 = la[b];
            std::vector<double>& d1 = ld[b];
            a3.assign((size_t)nv * 3, 0.0);
            d1.assign(nv, 0.0);
            for (long f = lo; f < hi; ++f) {
                int idx[3] = {faces[3 * f], faces[3 * f + 1],
                              faces[3 * f + 2]};
                for (int corner = 0; corner < 3; ++corner) {
                    int a = idx[corner];
                    int bb = idx[(corner + 1) % 3];
                    int c = idx[(corner + 2) % 3];
                    double ux = v[3 * bb] - v[3 * a];
                    double uy = v[3 * bb + 1] - v[3 * a + 1];
                    double uz = v[3 * bb + 2] - v[3 * a + 2];
                    double wx = v[3 * c] - v[3 * a];
                    double wy = v[3 * c + 1] - v[3 * a + 1];
                    double wz = v[3 * c + 2] - v[3 * a + 2];
                    double cx = uy * wz - uz * wy;
                    double cy = uz * wx - ux * wz;
                    double cz = ux * wy - uy * wx;
                    double cross = std::sqrt(cx * cx + cy * cy + cz * cz);
                    double dot = ux * wx + uy * wy + uz * wz;
                    double cot = dot / std::max(cross, 1e-12);
                    cot = std::min(std::max(cot, 0.0), 1e3);
                    // edge (b,c) gets cot at a, symmetric
                    for (int dir = 0; dir < 2; ++dir) {
                        int r = dir ? c : bb;
                        int s = dir ? bb : c;
                        a3[3 * r] += cot * v[3 * s];
                        a3[3 * r + 1] += cot * v[3 * s + 1];
                        a3[3 * r + 2] += cot * v[3 * s + 2];
                        d1[r] += cot;
                    }
                }
            }
        });
        const long used = nf > 0 ? (nf + fgrain - 1) / fgrain : 0;
        recon::parallel_for(nv, [&](long i) {
            double s0 = 0, s1 = 0, s2 = 0, sd = 0;
            for (long b = 0; b < used; ++b) {
                s0 += la[b][3 * i];
                s1 += la[b][3 * i + 1];
                s2 += la[b][3 * i + 2];
                sd += ld[b][i];
            }
            acc[3 * i] = s0; acc[3 * i + 1] = s1; acc[3 * i + 2] = s2;
            deg[i] = sd;
        });
        recon::parallel_for(nv, [&](long i) {
            if (is_bnd[i]) {
                nxt[3 * i] = v[3 * i];
                nxt[3 * i + 1] = v[3 * i + 1];
                nxt[3 * i + 2] = v[3 * i + 2];
                return;
            }
            double d = std::max(deg[i], 1e-12);
            for (int ax = 0; ax < 3; ++ax) {
                double avg = acc[3 * i + ax] / d;
                nxt[3 * i + ax] = v[3 * i + ax]
                                  + lam * (avg - v[3 * i + ax]);
            }
        });
        std::memcpy(v, nxt.data(), sizeof(double) * (size_t)nv * 3);
    }
}

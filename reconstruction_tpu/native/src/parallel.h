// Parallel loops on std::thread.  The library needs no OpenMP runtime:
// a compiler without libgomp builds the same multi-threaded library.
// (`#pragma omp simd` stays; -fopenmp-simd needs no runtime.)

#pragma once

#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace recon {

inline int num_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? (int)n : 1;
}

// Calls body(lo, hi) on disjoint ranges that cover [0, n), each at most
// `grain` long.  Up to num_threads() workers take the ranges in order
// from a shared counter, so uneven work balances itself.
template <typename F>
void parallel_ranges(long n, long grain, F&& body) {
    if (n <= 0) return;
    grain = std::max(grain, 1L);
    const long chunks = (n + grain - 1) / grain;
    const int nw = (int)std::min<long>(num_threads(), chunks);
    std::atomic<long> next{0};
    auto work = [&]() {
        for (long c; (c = next.fetch_add(1)) < chunks;)
            body(c * grain, std::min(n, (c + 1) * grain));
    };
    std::vector<std::thread> pool;
    pool.reserve(nw > 0 ? nw - 1 : 0);
    for (int t = 1; t < nw; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
}

// body(i) for every i in [0, n), one contiguous block per worker.
template <typename F>
void parallel_for(long n, F&& body) {
    const long nt = num_threads();
    parallel_ranges(n, (n + nt - 1) / nt, [&](long lo, long hi) {
        for (long i = lo; i < hi; ++i) body(i);
    });
}

}  // namespace recon

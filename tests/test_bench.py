"""Bench-harness unit tests.

Sweep bounds are ABSOLUTE target columns: passing [0, 63] for every
pixel would silently turn the "64-shift" sweep into a 1343-shift one —
these tests pin the harness semantics so that class of bug cannot recur.
"""

import json

import numpy as np
import jax.numpy as jnp

import bench


def test_kernel_sweep_bounds_are_exactly_64_shifts():
    """The roofline workload's per-pixel bounds must span exactly the 64
    shifts the analytic cost model budgets (s in [0, 63])."""
    H, W, nsh = 64, 128, 64
    k = bench.kernel_inputs(H, W, nsh)
    lo, hi = k["lo"], k["hi"]
    xg = jnp.arange(W, dtype=jnp.int32)[None, :]
    # the same derivation ncc_sweep_match applies
    s_lo = np.asarray(lo - xg).min()
    s_hi = np.asarray(hi - xg).max()
    assert s_lo == 0
    assert s_hi == nsh - 1
    # and per pixel the span never exceeds nsh
    span = np.asarray(hi - lo) + 1
    assert span.max() <= nsh
    assert span.min() >= 1
    assert k["imgL"].shape == (H, W, 3) and k["disp0"].shape == (H, W)


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_merge_falls_back_to_stereo_without_full_phase():
    results = {
        "stereo": {"matching_s": 1.0, "total_s": 1.0, "views_per_s": 2.0,
                   "stages_s": {"stereo": 1.0}, "mesh": {}},
        "kernels": {"refine": {"seconds": 0.05}},
    }
    out = json.loads(json.dumps(bench.merge(results, DEVICE)))
    assert out["value"] == 2.0
    assert "stereo_only" not in out
    assert out["kernels"]["refine"]["seconds"] == 0.05
    assert out["device"] == DEVICE


def test_merge_prefers_full_phase():
    results = {
        "stereo": {"matching_s": 1.0, "views_per_s": 2.0},
        "full": {"matching_s": 14.0, "total_s": 44.0, "views_per_s": 0.18,
                 "stages_s": {}, "mesh": {"surface_rmse": 0.0076}},
    }
    out = bench.merge(results, DEVICE)
    assert out["value"] == 0.18
    assert out["mesh"]["surface_rmse"] == 0.0076
    assert out["stereo_only"]["views_per_s"] == 2.0
    assert out["kernels"] == {}

"""Device profiling + roofline accounting.

The reference's only instrumentation is wall-clock printfs
(`reconstruction/main.cpp:7,18,22`).  This module provides:

  * `trace(path)`: context manager around `jax.profiler` for device
    traces viewable in TensorBoard/XProf.
  * `DEVICE_PEAKS` / `device_peaks`: published peaks per device kind.
  * `KernelCost`: analytic FLOP/byte counters for the framework's hot
    kernels + measured-time utilization against those peaks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import jax

# Published peaks per device, keyed by `jax.Device.device_kind`.  Dense
# rates without sparsity, at the card's full power limit.
#   NVIDIA H100 80GB HBM3 (SXM5): NVIDIA H100 Tensor Core GPU data sheet.
# flops_f32 is float32 outside the tensor cores: elementwise, select and
# reduction work, and f32 contractions pinned to HIGHEST precision, are
# judged against it.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops_bf16": 989e12, "flops_tf32": 495e12, "flops_f32": 67e12,
        "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9},
}


def device_peaks(device=None) -> Tuple[str, Dict[str, float]]:
    """(device_kind, peaks) of ``device`` (default: the first device).

    A device with no row in DEVICE_PEAKS, the CPU included, raises: a
    roofline share against a guessed peak is not a measurement."""
    d = device if device is not None else jax.devices()[0]
    kind = d.device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r} (platform "
            f"{d.platform!r}); add its data-sheet row to DEVICE_PEAKS")
    return kind, DEVICE_PEAKS[kind]


def require_gpu():
    """The first device, which must be a GPU; raises otherwise.  Every
    measurement and card-side check starts here, so a run that finds no
    card fails instead of reporting CPU numbers."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {d.platform!r} "
            f"({d.device_kind!r}); this needs an NVIDIA GPU")
    return d


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one line per
    card (read in a child process that never imports JAX)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


@contextlib.contextmanager
def trace(path: str) -> Iterator[None]:
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class KernelCost:
    flops: float
    hbm_bytes: float

    def utilization(self, seconds: float, kind: str) -> Dict[str, float]:
        """Achieved rates of one call that took ``seconds`` on a device
        of ``kind``, and their shares of its peaks."""
        peaks = DEVICE_PEAKS[kind]
        fpeak, bpeak = peaks["flops_f32"], peaks["hbm_bytes_per_s"]
        return {
            "gflops_per_s": self.flops / seconds / 1e9,
            "flops_util": self.flops / seconds / fpeak,
            "hbm_gbps": self.hbm_bytes / seconds / 1e9,
            "hbm_util": self.hbm_bytes / seconds / bpeak,
            "bound": ("hbm" if self.hbm_bytes / bpeak > self.flops / fpeak
                      else "flops"),
        }


def ncc_sweep_cost(H: int, W: int, C: int, radius: int,
                   num_shifts: int) -> KernelCost:
    """Cost of the uniform-shift NCC sweep (stereo/matching.py).

    FLOPs: per shift, C mults + C-1 adds for the channel product, 4r
    separable box adds, ~8 elementwise score/compare ops per pixel.

    Bytes: UNIQUE traffic of an ideally fused sweep — every operand
    read once per sweep and the state written once, as a kernel that
    keeps best-score/best-t and the shifted windows on chip across all
    shifts would move.  Utilization is then <= 1 by construction, and a
    LOW value says the per-shift loop formulation re-reads operands
    that a fused sweep could skip.

    Unique bytes/px: imgL + imgR (2*C*4), four moment maps (16),
    validR f32 (4), active (1), two bound maps (8), state out (8).
    """
    per_px = (2 * C - 1) + 4 * radius + 10
    flops = float(H * W * per_px * num_shifts)
    unique_bytes = H * W * (8.0 * C + 37.0)
    return KernelCost(flops=flops, hbm_bytes=unique_bytes)


def refine_cost(H: int, W: int, iterations: int,
                build_shifts: int, window: int = 32) -> KernelCost:
    """Cost of the mini-CV subpixel refine (stereo/refine.py).

    The banded cost-volume build is an NCC sweep over ``build_shifts``;
    each sweep then reads the pixel's ``window``-slot cost window plus
    its disparity and writes the disparity back (f32), and spends ~230
    elementwise ops per pixel on the window taps, the parabola/blend
    math and the exps.
    """
    build = ncc_sweep_cost(H, W, 3, 1, build_shifts)
    return KernelCost(
        flops=build.flops + H * W * 230.0 * iterations,
        hbm_bytes=build.hbm_bytes + H * W * 4.0 * (window + 2) * iterations,
    )


def poisson_cost(resolution: int) -> KernelCost:
    """Spectral Poisson solve: rfftn + irfftn + eigenvalue scaling."""
    n = resolution ** 3
    import math
    fft_flops = 2 * 5.0 * n * math.log2(max(n, 2))
    return KernelCost(flops=fft_flops + 10 * n, hbm_bytes=8.0 * n * 6)


def schur_cost(num_points: int, obs_per_point: int, num_cameras: int) -> KernelCost:
    """BA Schur assembly + reduction (ba/bundle_adjust.py, SoA form).

    FLOPs: ~250/obs analytic Jacobians + ~160/obs block products, plus
    the per-point W/WHinv/Schur contractions.  Bytes: the SoA
    implementation's named streams — 20 component arrays w+r plus the
    54-row stacks per obs, the (18, C, M) coupling reduce that re-reads
    the 18 He rows per camera (the dominant term, x C), and the three
    (6C, M) Schur matmul operand sets.
    """
    m, o, c = num_points, obs_per_point, num_cameras
    n = m * o
    per_obs = 250 + 160
    red = m * (c * 6 * 3 * 3 + c * c * 36 * 3)
    bytes_obs = n * (40 + 54) * 4          # component + stack streams
    bytes_w = n * 18 * 4 * c * 2           # He x one-hot fused reduce
    bytes_s = 6 * (c * 6) * m * 4          # Schur matmul operands
    return KernelCost(flops=float(n * per_obs + red),
                      hbm_bytes=float(bytes_obs + bytes_w + bytes_s))

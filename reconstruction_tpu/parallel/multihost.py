"""Multi-host initialization + mesh layout.

The reference is single-process (files as IPC, SURVEY.md section 5);
multi-host operation here rides `jax.distributed` + GSPMD.  Axis layout
rule: the `frame` axis maps across hosts (DCN — frames are independent,
traffic is zero until final artifact collection), `pair` and `tile` stay
within a slice (ICI — halo exchange and cloud fusion collectives).
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from reconstruction_tpu.parallel.mesh import make_mesh
from reconstruction_tpu.utils.logging import get_logger

log = get_logger(__name__)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """`jax.distributed.initialize` with env-var fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID)."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        log.info("single-process mode (no COORDINATOR_ADDRESS)")
        return
    num_processes = num_processes or int(os.environ["NUM_PROCESSES"])
    process_id = process_id if process_id is not None else int(
        os.environ["PROCESS_ID"])
    jax.distributed.initialize(coordinator_address, num_processes, process_id)
    log.info("distributed: process %d/%d, %d global devices",
             process_id, num_processes, len(jax.devices()))


def factor_pod(
    n_devices: int,
    n_local: int,
    frames_per_pod: Optional[int] = None,
) -> tuple:
    """(frame, pair, tile) factoring of n_devices.

    Invariants (tests/test_parallel.py::test_factor_pod_*):
      * frame * pair * tile == n_devices always (no dropped devices);
      * the frame axis defaults to the host count and is clamped DOWN to
        the largest divisor of n_devices <= the request, so uneven
        requests degrade instead of asserting;
      * frame == n_hosts keeps every frame row process-aligned (the DCN
        axis) when hosts are homogeneous (uniform per-host device
        counts), and the multihost test asserts the alignment.
    """
    n = max(n_devices, 1)
    n_hosts = max(n // max(n_local, 1), 1)
    frame = max(min(frames_per_pod or n_hosts, n), 1)
    while n % frame:
        frame -= 1  # largest feasible divisor <= the request
    per_frame = n // frame
    tile = 2 if per_frame % 2 == 0 and per_frame > 1 else 1
    pair = per_frame // tile
    return frame, pair, tile


def make_pod_mesh(frames_per_pod: Optional[int] = None):
    """Mesh over ALL global devices: frame axis spans hosts (DCN),
    pair/tile axes stay intra-host (ICI)."""
    devices = jax.devices()
    frame, pair, tile = factor_pod(len(devices), len(jax.local_devices()),
                                   frames_per_pod)
    if frames_per_pod and frame != frames_per_pod:
        log.warning("frames_per_pod=%d does not divide %d devices; using %d",
                    frames_per_pod, len(devices), frame)
    return make_mesh(devices, frame=frame, pair=pair, tile=tile)

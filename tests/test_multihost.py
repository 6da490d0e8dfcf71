"""First REAL multi-process run of the DCN code path (SURVEY.md §4 (d)):
two local processes join through `jax.distributed.initialize` (CPU
backend, localhost coordinator), build the pod mesh via
`parallel/multihost.make_pod_mesh`, run a cross-process psum, compute a
frame-sharded batch of two tiny takes, and all-gather the artifacts —
which must be identical to the sequential single-process run."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_batch(tmp_path):
    port = _free_port()
    nproc = 2
    # The workers pick their own platform and device count, and must
    # not initialize a backend before jax.distributed.initialize.
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid), str(nproc),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()  # exact PIDs we started
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"worker {pid} OK" in out

    data = np.load(tmp_path / "gathered.npz")

    # Sequential reference: same takes in THIS process (plain CPU jax).
    from multihost_scene import frame_take
    for f in range(nproc):
        seq = frame_take(f)
        np.testing.assert_allclose(data[f"frame{f}"], seq, atol=1e-5)
        valid = seq != -10000.0
        assert valid.sum() > 100  # the takes actually matched something

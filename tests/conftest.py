"""Test harness config.

Tests run on the CPU backend (JAX_PLATFORMS defaults to "cpu") with 8
virtual devices, so multi-device sharding (pair/tile/frame mesh axes) is
exercised without a GPU, per SURVEY.md section 4 (d).  The repo root and
this directory are put on sys.path so tests import `bench`, `chip_smoke`
and `synthetic` directly.

Tests that need the card carry the `gpu` marker and skip from inside the
`gpu_device` fixture; on a GPU machine run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`.
`python chip_smoke.py` is the full card-side check.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run the "
        "card-side checks with `python chip_smoke.py`)")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip.  Decided here, at run time, and
    never at import, so every test worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU visible to JAX (tests run on the CPU backend)")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "virtual CPU device mesh missing"
    return devs

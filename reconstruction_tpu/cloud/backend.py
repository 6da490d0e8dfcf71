"""Cloud-stage backend selection (jax device path vs native host path).

The cloud stages exist in two equivalent formulations:

  * "jax"    — streaming voxel-grid neighbor reduces on the accelerator
               (cloud/neighbors.py), the path that scales with device
               memory bandwidth and shards across a mesh;
  * "native" — multi-threaded C++ exact-k-NN grid on the host
               (native/src/cloud_stats.cpp), which matches PCL's
               exact-KNN semantics more closely than the capped device
               gather.

"auto" resolves to jax.  "native" is an explicit choice, in the config
or through RECON_CLOUD_BACKEND=jax|native.
"""

from __future__ import annotations

import os


def resolve_backend(backend: str = "auto") -> str:
    if backend == "auto":
        env = os.environ.get("RECON_CLOUD_BACKEND")
        if env in ("jax", "native"):
            backend = env
    if backend == "native":
        # An explicit "native" request (config or env) must not crash the
        # cloud stages with an opaque None-unpack when the library cannot
        # be built here: fall back to jax with a warning.
        from reconstruction_tpu import native
        if not native.available():
            from reconstruction_tpu.utils.logging import get_logger
            get_logger(__name__).warning(
                "cloud backend 'native' requested but librecon_native "
                "could not be built; falling back to 'jax'")
            return "jax"
        return "native"
    if backend != "auto":
        return backend
    return "jax"

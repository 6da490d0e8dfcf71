"""Batched device->host transfer.

Each fetch pays a fixed latency besides its bytes, so eight separate
np.asarray calls per stereo pair cost more in latency than in bytes.
fetch_packed bitcasts every array to uint8 on device, concatenates, and
fetches ONE buffer, reconstructing the originals host-side by view.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_PACKERS = {}  # casts-signature -> jitted packer (see fetch_packed)

def _get_packer(casts):
    """Jitted packer for one casts signature (jit then caches by input
    shapes): the whole pack is ONE program instead of one dispatch per
    array bitcast/cast."""
    import jax
    import jax.numpy as jnp

    def _pack_impl(*arrs):
        parts = []
        for a, cast in zip(arrs, casts):
            if cast == "u8":
                a = jnp.clip(a, 0, 255).astype(jnp.uint8)
            dt = np.dtype(a.dtype)
            if dt == np.uint8:
                b = a.reshape(-1)
            elif dt == np.bool_:
                b = a.astype(jnp.uint8).reshape(-1)
            else:
                b = jax.lax.bitcast_convert_type(a, jnp.uint8).reshape(-1)
            parts.append(b)
        return jnp.concatenate(parts)

    return jax.jit(_pack_impl)


def fetch_packed(arrays: Sequence, casts: Sequence = None) -> List[np.ndarray]:
    """Fetch a list of jax arrays as one device->host transfer.

    Returns numpy arrays with the original shapes/dtypes (bool included).
    Numpy inputs pass through untouched.  casts[i] == "u8" converts that
    array to uint8 INSIDE the packed program (clip 0..255 + truncate,
    the pipeline's to_u8 semantics).
    """
    casts = list(casts) if casts is not None else [None] * len(arrays)
    parts, metas, part_casts = [], [], []
    for a, cast in zip(arrays, casts):
        if isinstance(a, np.ndarray):
            metas.append(("np", a, None, 0))
            continue
        dt = np.uint8 if cast == "u8" else np.dtype(a.dtype)
        dt = np.dtype(dt)
        nbytes = int(np.prod(a.shape, dtype=np.int64)) * (
            1 if dt in (np.uint8, np.bool_) else dt.itemsize)
        metas.append(("jax", a.shape, dt, nbytes))
        parts.append(a)
        part_casts.append(cast)
    if not parts:
        return [m[1] for m in metas]
    key = tuple(part_casts)
    packer = _PACKERS.get(key)
    if packer is None:
        packer = _PACKERS[key] = _get_packer(key)
    buf = np.asarray(packer(*parts))
    out, off = [], 0
    for kind, shape, dt, nbytes in metas:
        if kind == "np":
            out.append(shape)  # the passthrough array itself
            continue
        raw = buf[off:off + nbytes]
        off += nbytes
        if dt == np.bool_:
            out.append(raw.astype(bool).reshape(shape))
        else:
            out.append(np.frombuffer(raw.tobytes(), dtype=dt).reshape(shape))
    return out

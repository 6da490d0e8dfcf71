"""ctypes loader for the native host components.

The library is built from `src/` with the Makefile at first use (g++
with std::thread, no OpenMP runtime; `make -C reconstruction_tpu/native`
does the same by hand) and rebuilt when a source is newer than it.  All callers fall back to
pure-Python implementations when it cannot be built, so the framework
works without a compiler; the native paths take over transparently for
the host-bound hot spots (isosurface extraction, PLY payload packing).
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

LIB_NAME = "librecon_native.so"
_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _up_to_date(path: str, directory: str) -> bool:
    if not os.path.exists(path):
        return False
    inputs = (glob.glob(os.path.join(directory, "src", "*.cpp"))
              + glob.glob(os.path.join(directory, "src", "*.h")))
    inputs.append(os.path.join(directory, "Makefile"))
    return os.path.getmtime(path) >= max(os.path.getmtime(p) for p in inputs)


def build(directory: str = _DIR) -> Optional[str]:
    """Build ``directory``/librecon_native.so unless it is up to date;
    returns its path, or None if the build failed.

    Safe under concurrent callers (test workers import at once): the
    build holds an exclusive lock file, compiles to a temporary name and
    renames it into place, so no caller ever loads a half-written file.
    """
    import fcntl
    path = os.path.join(directory, LIB_NAME)
    if _up_to_date(path, directory):
        return path
    with open(os.path.join(directory, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _up_to_date(path, directory):  # built while we waited
            return path
        tmp = f"{LIB_NAME}.{os.getpid()}.tmp"
        try:
            r = subprocess.run(["make", "-s", "-C", directory, f"LIB={tmp}"],
                               capture_output=True, text=True)
        except OSError as e:  # no make on this host
            r = subprocess.CompletedProcess(e.filename, 127, "", str(e))
        if r.returncode != 0:
            from reconstruction_tpu.utils.logging import get_logger
            get_logger(__name__).warning(
                "building %s failed (rc %s): %s", LIB_NAME, r.returncode,
                (r.stderr or r.stdout)[-2000:])
            if os.path.exists(os.path.join(directory, tmp)):
                os.remove(os.path.join(directory, tmp))
            return None
        os.replace(os.path.join(directory, tmp), path)
    return path


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.mt_count.restype = ctypes.c_long
        lib.mt_count.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_float]
        lib.mt_extract.restype = ctypes.c_long
        lib.mt_extract.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.ply_pack.restype = ctypes.c_long
        lib.ply_pack.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.ply_pack_faces.restype = None
        lib.native_threads.restype = ctypes.c_int
        lib.native_threads.argtypes = []
        lib.ply_pack_faces.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        cfp = ctypes.POINTER(ctypes.c_float)
        cup = ctypes.POINTER(ctypes.c_uint8)
        lib.cloud_sor_stats.restype = None
        lib.cloud_sor_stats.argtypes = [
            cfp, cup, ctypes.c_long, ctypes.c_float, ctypes.c_int, cfp, cup]
        lib.cloud_normals.restype = None
        lib.cloud_normals.argtypes = [
            cfp, cup, ctypes.c_long, ctypes.c_float, cfp, cfp]
        lib.cloud_mls.restype = None
        lib.cloud_mls.argtypes = [
            cfp, cup, ctypes.c_long, ctypes.c_float, cfp, cfp, cfp, cup]
        lib.remap_bilinear_f32.restype = None
        lib.remap_bilinear_f32.argtypes = [
            cfp, ctypes.c_long, ctypes.c_long, ctypes.c_long, cfp, cfp,
            ctypes.c_long, ctypes.c_long, ctypes.c_float, cfp]
        cdp = ctypes.POINTER(ctypes.c_double)
        lib.laplacian_cotan.restype = None
        lib.laplacian_cotan.argtypes = [
            cdp, ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.c_int, ctypes.c_double, cup]
        _LIB = lib
    except (OSError, AttributeError):  # unloadable or missing symbols
        _LIB = None
    return _LIB


def available() -> bool:
    return load() is not None


def threads() -> int:
    """Worker threads of the library's parallel loops (0 if it is
    unavailable)."""
    lib = load()
    return lib.native_threads() if lib is not None else 0


def marching_tets_native(chi: np.ndarray, iso: float) -> Optional[np.ndarray]:
    """Triangle soup (T, 3, 3) in grid coords, or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    chi = np.ascontiguousarray(chi, np.float32)
    rx, ry, rz = chi.shape
    ptr = chi.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    count = lib.mt_count(ptr, rx, ry, rz, ctypes.c_float(iso))
    out = np.empty((count, 3, 3), np.float32)
    lib.mt_extract(ptr, rx, ry, rz, ctypes.c_float(iso),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count)
    return out


def pack_vertices(xyz: np.ndarray, normals: Optional[np.ndarray],
                  colors: Optional[np.ndarray], bgr: bool) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    rec = 12 + (12 if normals is not None else 0) + (3 if colors is not None else 0)
    out = np.empty(n * rec, np.uint8)
    nrm_p = (np.ascontiguousarray(normals, np.float32).ctypes
             .data_as(ctypes.POINTER(ctypes.c_float))
             if normals is not None else None)
    rgb_p = (np.ascontiguousarray(colors, np.uint8).ctypes
             .data_as(ctypes.POINTER(ctypes.c_uint8))
             if colors is not None else None)
    lib.ply_pack(n, xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 nrm_p, rgb_p, int(bgr),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


def pack_faces(faces: np.ndarray) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty(len(faces) * 13, np.uint8)
    lib.ply_pack_faces(len(faces),
                       faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def cloud_sor_stats(pts: np.ndarray, valid: np.ndarray, cell: float,
                    k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Exact-within-27-cells k-NN mean distance (see src/cloud_stats.cpp);
    None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    n = len(pts)
    mean_d = np.empty(n, np.float32)
    has = np.empty(n, np.uint8)
    lib.cloud_sor_stats(_f32p(pts), _u8p(v), n, ctypes.c_float(cell),
                        int(k), _f32p(mean_d), _u8p(has))
    return mean_d, has.astype(bool)


def cloud_normals(pts: np.ndarray, valid: np.ndarray, radius: float,
                  viewpoint: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    vp = np.ascontiguousarray(viewpoint, np.float32)
    out = np.empty_like(pts)
    lib.cloud_normals(_f32p(pts), _u8p(v), len(pts),
                      ctypes.c_float(radius), _f32p(vp), _f32p(out))
    return out


def cloud_mls(pts: np.ndarray, valid: np.ndarray, radius: float,
              prev_normals: np.ndarray
              ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    pn = np.ascontiguousarray(prev_normals, np.float32)
    out_p = np.empty_like(pts)
    out_n = np.empty_like(pts)
    ok = np.empty(len(pts), np.uint8)
    lib.cloud_mls(_f32p(pts), _u8p(v), len(pts), ctypes.c_float(radius),
                  _f32p(pn), _f32p(out_p), _f32p(out_n), _u8p(ok))
    return out_p, out_n, ok.astype(bool)


def remap_bilinear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray,
                   fill: float = 0.0) -> Optional[np.ndarray]:
    """Host bilinear remap (same taps/fill as core.remap.remap_bilinear);
    None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    img = np.ascontiguousarray(img, np.float32)
    mapx = np.ascontiguousarray(mapx, np.float32)
    mapy = np.ascontiguousarray(mapy, np.float32)
    H, W, C = img.shape
    Ho, Wo = mapx.shape
    out = np.empty((Ho, Wo, C), np.float32)
    lib.remap_bilinear_f32(_f32p(img), H, W, C, _f32p(mapx), _f32p(mapy),
                           Ho, Wo, ctypes.c_float(fill), _f32p(out))
    return out[..., 0] if squeeze else out


def laplacian_cotan(verts: np.ndarray, faces: np.ndarray, iterations: int,
                    lam: float, is_bnd: np.ndarray) -> Optional[np.ndarray]:
    """In-place-style cotangent Laplacian smoothing; returns the smoothed
    float64 vertex array, or None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64).copy()
    f = np.ascontiguousarray(faces, np.int32)
    bnd = np.ascontiguousarray(is_bnd, np.uint8)
    lib.laplacian_cotan(v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        len(v), f.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int32)),
                        len(f), int(iterations), float(lam),
                        bnd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return v

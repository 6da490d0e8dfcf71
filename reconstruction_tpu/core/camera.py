"""Pinhole camera model.

The reference keeps per-camera K (3x3 intrinsics), [R|t] (3x4 extrinsics)
and the camera center C = -R^T t in the `camera` struct
(`reconstruction/CManageData.h:16-26`, `CManageData.cpp:45-64`).  Here the
same quantities live in a small pytree-friendly dataclass so whole rigs can
be stacked, vmapped and sharded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reconstruction_tpu.config import GEOMETRY_PRECISION


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Camera:
    """One calibrated pinhole camera.

    Attributes:
      K: (..., 3, 3) intrinsics.
      Rt: (..., 3, 4) extrinsics, world -> camera: x_cam = R @ x_world + t.
    """

    K: jnp.ndarray
    Rt: jnp.ndarray

    @property
    def R(self) -> jnp.ndarray:
        return self.Rt[..., :, :3]

    @property
    def t(self) -> jnp.ndarray:
        return self.Rt[..., :, 3]

    @property
    def center(self) -> jnp.ndarray:
        """C = -R^T t (`CManageData.cpp:61`)."""
        return -jnp.einsum("...ji,...j->...i", self.R, self.t,
                           precision=GEOMETRY_PRECISION)

    @property
    def P(self) -> jnp.ndarray:
        """3x4 projection matrix K [R|t]."""
        return jnp.einsum("...ij,...jk->...ik", self.K, self.Rt,
                          precision=GEOMETRY_PRECISION)

    def project(self, pts: jnp.ndarray) -> jnp.ndarray:
        """Project world points (..., N, 3) to pixel coords (..., N, 2)."""
        cam = (jnp.einsum("...ij,...nj->...ni", self.R, pts, precision=GEOMETRY_PRECISION)
               + self.t[..., None, :])
        img = jnp.einsum("...ij,...nj->...ni", self.K, cam, precision=GEOMETRY_PRECISION)
        return img[..., :2] / img[..., 2:3]

    def stack(cameras: Sequence["Camera"]) -> "Camera":
        return Camera(
            K=jnp.stack([c.K for c in cameras]),
            Rt=jnp.stack([c.Rt for c in cameras]),
        )


@dataclass(frozen=True)
class CameraPair:
    """A stereo pair with file pointers, mirroring
    `CManageData::cam[pair][0..1]` (`CManageData.cpp:50-64`)."""

    left: Camera
    right: Camera
    left_id: int
    right_id: int
    left_image: str = ""
    right_image: str = ""
    left_mask: str = ""
    right_mask: str = ""


def make_camera(K, Rt) -> Camera:
    K = jnp.asarray(K, jnp.float32)
    Rt = jnp.asarray(Rt, jnp.float32)
    return Camera(K=K, Rt=Rt)


def load_calibration(calib: Dict[str, np.ndarray], cam_ids: Sequence[int]) -> Dict[int, Camera]:
    """Build Camera objects from a parsed calibration dict with keys
    ``intrinsic-<id>`` / ``extrinsic-<id>`` (`CManageData.cpp:59-60`)."""
    out = {}
    for cid in cam_ids:
        K = np.asarray(calib[f"intrinsic-{cid}"], np.float64).reshape(3, 3)
        Rt = np.asarray(calib[f"extrinsic-{cid}"], np.float64).reshape(3, 4)
        out[cid] = make_camera(K, Rt)
    return out


def relative_pose(cam0: Camera, cam1: Camera) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pose of cam1 relative to cam0: x1 = R x0 + T
    (`CStereoMatching.cpp:125-126`)."""
    R = cam1.R @ cam0.R.T
    T = -R @ cam0.t + cam1.t
    return R, T


def synthetic_rig(
    num_cameras: int = 2,
    radius: float = 10.0,
    span_deg: float = 20.0,
    focal: float = 800.0,
    image_size: Tuple[int, int] = (640, 480),
    look_at: Sequence[float] = (0.0, 0.0, 0.0),
) -> list:
    """A synthetic inward-facing camera arc for tests and benchmarks."""
    w, h = image_size
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float64)
    cams = []
    center = np.asarray(look_at, np.float64)
    angles = np.linspace(-span_deg / 2, span_deg / 2, num_cameras) * np.pi / 180.0
    for a in angles:
        cpos = center + radius * np.array([np.sin(a), 0.0, -np.cos(a)])
        fwd = center - cpos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd])  # rows: camera axes in world coords
        t = -R @ cpos
        cams.append(make_camera(K, np.concatenate([R, t[:, None]], axis=1)))
    return cams

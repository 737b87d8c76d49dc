"""Camera model as a dataclass of float32 tensors (counterpart of
``skelsplat_tpu/core/cameras.py``). A batched Camera has a leading view axis
on every field; the trainer treats that axis as a batch dimension."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core import geometry

ZNEAR = 0.01
ZFAR = 100.0

FIELDS = ("view4", "proj4", "full4", "cam_center", "focal_x", "focal_y",
          "tan_fovx", "tan_fovy", "width", "height", "uid")
# each field's own (non-batch) rank
_FIELD_NDIM = {"view4": 2, "proj4": 2, "full4": 2, "cam_center": 1}


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole view, or a batch with leading axes on every field.

    Matrices are in plain math convention: ``view4 @ [p;1]`` maps
    world→camera and ``full4 = proj4 @ view4`` maps world→clip.
    """

    view4: torch.Tensor       # (…,4,4) world→view
    proj4: torch.Tensor       # (…,4,4) intrinsics frustum
    full4: torch.Tensor       # (…,4,4) proj4 @ view4
    cam_center: torch.Tensor  # (…,3)
    focal_x: torch.Tensor     # (…,)
    focal_y: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: torch.Tensor       # (…,) float32 true image width
    height: torch.Tensor
    uid: torch.Tensor         # (…,) int32

    def map(self, fn) -> "Camera":
        """Apply ``fn`` to every field."""
        return Camera(**{f: fn(getattr(self, f)) for f in FIELDS})

    def take(self, idx) -> "Camera":
        """Views ``idx`` (an index or an index tensor) of a batched Camera."""
        return self.map(lambda x: x[idx])

    def per_point(self) -> "Camera":
        """Fields reshaped to broadcast against (…, N) point batches: a
        trailing unit axis before each field's own shape (see
        core/geometry.py for the convention)."""
        return Camera(**{
            f: getattr(self, f).unsqueeze(
                getattr(self, f).dim() - _FIELD_NDIM.get(f, 0))
            for f in FIELDS})


def camera_arrays(R: np.ndarray, T: np.ndarray, K: np.ndarray,
                  width: int, height: int, uid: int = 0,
                  trans: np.ndarray | None = None,
                  scale: float = 1.0) -> dict[str, np.ndarray]:
    """Host-side Camera fields (numpy) from loader-convention extrinsics
    (transposed ``R``, world→camera ``T``) and intrinsics ``K``. The focal
    the kernel sees is size / (2·tan(fov/2)) from the fov round trip, not
    K's focal."""
    w2v = geometry.world2view(R, T, trans, scale).astype(np.float64)
    proj = geometry.projection_from_K(ZNEAR, ZFAR, K, width, height).astype(np.float64)
    full = (proj @ w2v).astype(np.float32)
    c2w = np.linalg.inv(w2v)
    fov_x = geometry.focal2fov(K[0, 0], width)
    fov_y = geometry.focal2fov(K[1, 1], height)
    tan_fovx = math.tan(fov_x * 0.5)
    tan_fovy = math.tan(fov_y * 0.5)
    f32 = np.float32
    return dict(
        view4=w2v.astype(np.float32),
        proj4=proj.astype(np.float32),
        full4=full,
        cam_center=c2w[:3, 3].astype(np.float32),
        focal_x=f32(width / (2.0 * tan_fovx)),
        focal_y=f32(height / (2.0 * tan_fovy)),
        tan_fovx=f32(tan_fovx),
        tan_fovy=f32(tan_fovy),
        width=f32(width),
        height=f32(height),
        uid=np.int32(uid),
    )


def camera_from_arrays(fields, device="cuda") -> Camera:
    """A Camera on ``device`` from a mapping of its fields (numpy arrays,
    batched or not)."""
    dev = resolve_device(device)
    return Camera(**{f: torch.as_tensor(np.asarray(fields[f]), device=dev)
                     for f in FIELDS})


def make_camera(R: np.ndarray, T: np.ndarray, K: np.ndarray,
                width: int, height: int, uid: int = 0,
                trans: np.ndarray | None = None, scale: float = 1.0,
                device="cuda") -> Camera:
    """One Camera on ``device`` (see ``camera_arrays``)."""
    return camera_from_arrays(
        camera_arrays(R, T, K, width, height, uid, trans, scale), device)


def stack_cameras(cams: list[Camera]) -> Camera:
    """Stack V single Cameras into one batched Camera (leading axis V)."""
    return Camera(**{f: torch.stack([getattr(c, f) for c in cams])
                     for f in FIELDS})

"""Per-dataset camera calibration loaders (counterpart of
``skelsplat_tpu/data/cameras_io.py``).

Each dataset's convention is kept: the H36M/Panoptic quaternion round trip
and transpose of R, Panoptic's cm→mm ×10 on t, Occlusion-Person's
t = −R·T and plain transpose, and the per-subject H36M image sizes. The
records are numpy on the host; ``build_camera_batch`` makes the port's
``core/cameras.Camera`` on an explicit device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import lru_cache

import numpy as np

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.cameras import (FIELDS, Camera, camera_arrays,
                                              camera_from_arrays)

# (width, height) per [subject S1..S11][camera 0..3]
H36M_CAMERA_SIZE = [
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1002, 1000), (1002, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1002, 1000), (1002, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
    [(1002, 1000), (1002, 1000), (1002, 1000), (1002, 1000)],
    [(1002, 1000), (1000, 1000), (1000, 1000), (1002, 1000)],
]

H36M_CAMERAS = ["54138969", "55011271", "58860488", "60457274"]
PANOPTIC_CAMERAS = ["00_01", "00_02", "00_10", "00_13",
                    "00_03", "00_23", "00_19", "00_30"]
OP_CAMERAS = ["0", "1", "2", "3", "4", "5", "6", "7"]


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Loader-side camera record, numpy on the host."""

    uid: int
    R: np.ndarray       # transposed world→cam rotation (glm convention)
    T: np.ndarray       # translation
    K: np.ndarray       # 3×3 intrinsics
    width: int
    height: int

    def arrays(self, uid: int | None = None) -> dict[str, np.ndarray]:
        """This camera's ``Camera`` fields as numpy arrays."""
        return camera_arrays(self.R, self.T, self.K, self.width, self.height,
                             uid=self.uid if uid is None else uid)


def _quat_roundtrip_transpose(R: np.ndarray) -> np.ndarray:
    """R → scipy quaternion → (w,x,y,z) → rotation matrix → transpose. The
    round trip is numerically (not bitwise) R.T; kept for fidelity."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()
    qvec = np.array([q[3], q[0], q[1], q[2]])
    return np.transpose(geometry.qvec2rotmat(qvec))


def get_h36m_camera(camera_data: dict, subject: str, camera: str) -> CameraInfo:
    """One H36M camera of ``subject`` from camera-parameters.json."""
    K = np.array(camera_data["intrinsics"][camera]["calibration_matrix"],
                 dtype=np.float64).reshape(3, 3)
    ext = camera_data["extrinsics"][subject][camera]
    R = np.array(ext["R"], dtype=np.float64).reshape(3, 3)
    T = np.array(ext["t"], dtype=np.float64).reshape(3)
    subject_id = int(subject.strip("S")) - 1
    # real H36M uses the per-subject size table; synthetic datasets may
    # carry their own sizes in the calibration json
    if "image_sizes" in camera_data:
        width, height = camera_data["image_sizes"][camera]
    else:
        width, height = H36M_CAMERA_SIZE[subject_id][H36M_CAMERAS.index(camera)]
    return CameraInfo(uid=H36M_CAMERAS.index(camera),
                      R=_quat_roundtrip_transpose(R), T=T, K=K.copy(),
                      width=width, height=height)


@lru_cache(maxsize=64)
def _panoptic_calibration(data_root: str, activity: str) -> dict:
    path = os.path.join(data_root, "3d_gt", "cameras",
                        f"calibration_{activity}.json")
    with open(path) as f:
        return json.load(f)


def get_panoptic_camera(data_root: str, activity: str, camera: str) -> CameraInfo:
    """One Panoptic camera (t ×10: cm → mm)."""
    cal = _panoptic_calibration(data_root, activity)
    for data in cal["cameras"]:
        if data["name"] == camera:
            K = np.array(data["K"], dtype=np.float64).reshape(3, 3)
            R = np.array(data["R"], dtype=np.float64).reshape(3, 3)
            T = (np.array(data["t"], dtype=np.float64).reshape(3, 1) * 10)
            break
    else:
        raise KeyError(f"camera {camera} not in calibration_{activity}.json")
    # real Panoptic is fixed 1920x1080; synthetic calibrations may override
    width, height = cal.get("image_size", (1920, 1080))
    return CameraInfo(uid=PANOPTIC_CAMERAS.index(camera),
                      R=_quat_roundtrip_transpose(R), T=T.reshape(3),
                      K=K.copy(), width=width, height=height)


def get_occlusion_person_camera(camera_data: dict, scene_id: int,
                                cam: int) -> CameraInfo:
    """One Occlusion-Person camera (t = −R·T, plain transpose on R)."""
    camera = camera_data[str(scene_id)][cam]
    width, height = camera.get("image_size", (1280, 720))
    K = np.array([[camera["fx"], 0, camera["cx"]],
                  [0, camera["fy"], camera["cy"]],
                  [0, 0, 1]], dtype=np.float64)
    R = np.array(camera["R"], dtype=np.float64).reshape(3, 3)
    T = -R @ np.array(camera["T"], dtype=np.float64).reshape(3, 1)
    return CameraInfo(uid=cam, R=np.transpose(R), T=T.reshape(3), K=K,
                      width=width, height=height)


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    """One entry of the per-run cameras.json artifact."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    fovy = geometry.focal2fov(cam.K[1, 1], cam.height)
    fovx = geometry.focal2fov(cam.K[0, 0], cam.width)
    return {
        "id": idx,
        "img_name": "",
        "width": int(cam.width),
        "height": int(cam.height),
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": geometry.fov2focal(fovy, cam.height),
        "fx": geometry.fov2focal(fovx, cam.width),
    }


def build_camera_batch(cam_infos: list[CameraInfo], device="cuda") -> Camera:
    """A batched ``Camera`` on ``device`` from a list of records; uid is
    the list position."""
    dev = resolve_device(device)
    per_view = [c.arrays(uid=i) for i, c in enumerate(cam_infos)]
    return camera_from_arrays(
        {f: np.stack([a[f] for a in per_view]) for f in FIELDS}, dev)

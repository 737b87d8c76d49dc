"""Dataset tree loader (counterpart of ``skelsplat_tpu/data/loader.py``).

Walks ``initial_guess/<name>/<subject>/<activity>``, loads the 3D GT, the
initial guesses and the per-camera 2D poses, applies the frame_step
subsampling and the start/end scene-id window, and yields per-scene
records of plain numpy. The dataset is chosen by a substring of
``data_root`` ("h36m", "panoptic" or "occlusion-person"). Camera
calibration is parsed once per (subject, activity). The layout rules:
the npz key fallbacks, Panoptic's ``poses_filtered_{nviews}`` files,
Occlusion-Person's every other camera at nviews=4, and
``{subject}_{activity}_{frame_id:06d}`` scene names.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np

from skelsplat_tpu_torch.data import cameras_io
from skelsplat_tpu_torch.data.cameras_io import CameraInfo

NPZ_KEYS = ["poses", "poses2d", "boxes", "poses3d", "scores", "joint_errors"]


def load_npz(file_path: str):
    """The first of NPZ_KEYS that an npz holds (None if no such file)."""
    if os.path.exists(file_path):
        data = np.load(file_path, allow_pickle=True)
        for key in NPZ_KEYS:
            if key in data:
                return data[key]
    return None


@dataclasses.dataclass
class SceneRecord:
    scene_id: int
    pose_3d: np.ndarray        # (N,3) initial guess
    pose_3d_gt: np.ndarray     # (N,3)
    poses_2d: np.ndarray       # (V,N,2)
    cameras: list[CameraInfo]
    scene_name: str            # f"{subject}_{activity}_{frame_id:06d}"


class DataLoader:
    """Iterates (scene_id, SceneRecord) over the dataset window."""

    def __init__(self, data_root: str, initial_guess_dir: str,
                 poses_2d_dir: str, frame_step: int = 64, start_id: int = 0,
                 end_id: int = 2181, nviews: int = 4):
        self.data_root = data_root
        self.initial_guess_dir = initial_guess_dir
        self.poses_2d_dir = poses_2d_dir
        self.frame_step = frame_step
        self.start_id = start_id
        self.end_id = end_id
        self.gt_3d_dir = os.path.join(data_root, "3d_gt")
        self.gt_2d_dir = os.path.join(data_root, "2d_gt")
        self.n_views = nviews

        if "h36m" in data_root:
            meta = os.path.join(data_root, "initial_guess", "cameras",
                                "camera-parameters.json")
            with open(meta) as f:
                self.camera_data = json.load(f)
            self.n_joints, self.im_width, self.im_height = 17, 1000, 1000
            self.cameras = list(cameras_io.H36M_CAMERAS)
            self._kind = "h36m"
        elif "panoptic" in data_root:
            self.camera_data = None
            self.n_joints, self.im_width, self.im_height = 19, 1920, 1080
            self.cameras = list(cameras_io.PANOPTIC_CAMERAS)
            self._kind = "panoptic"
        elif "occlusion-person" in data_root:
            meta = os.path.join(data_root, "cameras.json")
            with open(meta) as f:
                self.camera_data = json.load(f)
            self.n_joints, self.im_width, self.im_height = 15, 1280, 720
            self.cameras = list(cameras_io.OP_CAMERAS)
            self._kind = "occlusion-person"
        else:
            raise ValueError(f"Could not recognize dataset at {data_root!r}")

        self.scene_mapping = self._create_scene_mapping()

    # ------------------------------------------------------------------
    def _camera_infos(self, subject: str, activity: str, scene_id: int,
                      cameras: list[str]) -> list[CameraInfo]:
        infos = []
        for camera in cameras:
            if self._kind == "h36m":
                infos.append(cameras_io.get_h36m_camera(
                    self.camera_data, subject, camera))
            elif self._kind == "panoptic":
                infos.append(cameras_io.get_panoptic_camera(
                    self.data_root, activity, camera))
            else:
                infos.append(cameras_io.get_occlusion_person_camera(
                    self.camera_data, scene_id, int(camera)))
        return infos

    def _create_scene_mapping(self) -> dict[int, SceneRecord]:
        mapping: dict[int, SceneRecord] = {}
        scene_id = 0
        subjects = sorted(os.listdir(self.initial_guess_dir))
        for subject in subjects:
            subject_path_3d = os.path.join(self.initial_guess_dir, subject)
            subject_path_2d = os.path.join(self.poses_2d_dir, subject)
            if not os.path.isdir(subject_path_3d):
                continue
            for activity in sorted(os.listdir(subject_path_3d)):
                activity_path_3d = os.path.join(subject_path_3d, activity)
                activity_path_2d = os.path.join(subject_path_2d, activity)
                gt_3d_path = os.path.join(self.gt_3d_dir, subject, activity)

                # 3D GT (panoptic: the view-filtered variant)
                if self._kind == "panoptic":
                    poses_3d_gt = load_npz(os.path.join(
                        gt_3d_path, f"poses_filtered_{self.n_views}.npz"))
                else:
                    poses_3d_gt = load_npz(os.path.join(gt_3d_path, "poses.npz"))
                poses_3d_gt = np.array(
                    [poses_3d_gt[i] for i in
                     range(0, poses_3d_gt.shape[0], self.frame_step)])

                # 3D initial guess ("gt" in the dir name ⇒ use the GT)
                if "gt" in self.initial_guess_dir:
                    poses_3d = poses_3d_gt
                else:
                    poses_3d = load_npz(os.path.join(activity_path_3d,
                                                     "poses.npz"))

                if not os.path.isdir(activity_path_2d):
                    print(f"Activity path {activity_path_2d} does not exist "
                          f"for subject {subject}, activity {activity}. "
                          "Skipping...")
                    continue

                cameras = self.cameras[: self.n_views]
                if self._kind == "occlusion-person" and self.n_views == 4:
                    # every other camera
                    cameras = sorted(os.listdir(activity_path_2d))[1::2]

                poses_2d_fcam = []
                for camera in cameras:
                    cam_dir = os.path.join(activity_path_2d, camera)
                    if self._kind == "panoptic":
                        poses_2d = load_npz(os.path.join(
                            cam_dir,
                            f"poses_filtered_{self.n_views}.npz"))[..., :2]
                    else:
                        poses_2d = load_npz(
                            os.path.join(cam_dir, "poses.npz"))[..., :2]
                    if "gt" in self.poses_2d_dir:
                        poses_2d = np.array(
                            [poses_2d[i] for i in
                             range(0, poses_2d.shape[0],
                                   self.frame_step)])[..., :2]
                    if poses_2d.shape[0] > poses_3d.shape[0]:
                        poses_2d = poses_2d[: poses_3d.shape[0]]
                    poses_2d_fcam.append(poses_2d)
                poses_2d_fcam = np.array(poses_2d_fcam).reshape(
                    self.n_views, -1, self.n_joints, 2)

                for frame in range(poses_3d.shape[0]):
                    if self.end_id is not None and self.end_id > 0:
                        if scene_id >= self.end_id:
                            return mapping
                    if scene_id >= self.start_id:
                        frame_id = frame * self.frame_step
                        scene_name = f"{subject}_{activity}_{frame_id:06d}"
                        mapping[scene_id] = SceneRecord(
                            scene_id=scene_id,
                            pose_3d=np.asarray(poses_3d[frame],
                                               dtype=np.float32),
                            pose_3d_gt=np.asarray(poses_3d_gt[frame],
                                                  dtype=np.float32),
                            poses_2d=np.asarray(poses_2d_fcam[:, frame],
                                                dtype=np.float32),
                            cameras=self._camera_infos(
                                subject, activity, scene_id, cameras),
                            scene_name=scene_name,
                        )
                    scene_id += 1
        return mapping

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.scene_mapping)

    def __iter__(self) -> Iterator[tuple[int, SceneRecord]]:
        yield from self.scene_mapping.items()

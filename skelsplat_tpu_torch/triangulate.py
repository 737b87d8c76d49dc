"""DLT multi-camera triangulation of 2D detections (counterpart of
``skelsplat_tpu/triangulate.py``).

It writes the ``point_cloud/iteration_0/{scene}.ply`` initial-guess clouds.
The projection matrices are built per dataset on the host in float64
(K·[R|t]: H36M per-subject extrinsics, Panoptic per-activity calibration
with t ×10 from cm to mm, Occlusion-Person's every other camera with
t = −R·T). Each scene's joints are solved together: one batched
``torch.linalg.svd`` in float64 on the run's device over the (N, 2V, 4)
homogeneous systems. The SVD's sign ambiguity cancels in X / X[3].
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.data.cameras_io import (H36M_CAMERAS, OP_CAMERAS,
                                                 PANOPTIC_CAMERAS)


# --------------------------- projection matrices ---------------------------

def get_calibration_matrices_h36m(camera_data):
    """The four H36M cameras' 3×3 intrinsics."""
    return [np.array(camera_data["intrinsics"][cam]["calibration_matrix"],
                     dtype=np.float64).reshape(3, 3)
            for cam in H36M_CAMERAS]


def get_extrinsics_h36m(camera_data, subject_id):
    """(R list, t list) of ``subject_id``'s four H36M cameras."""
    R, t = [], []
    for cam in H36M_CAMERAS:
        ext = camera_data["extrinsics"][subject_id][cam]
        R.append(np.array(ext["R"], dtype=np.float64).reshape(3, 3))
        t.append(np.array(ext["t"], dtype=np.float64).reshape(3, 1))
    return R, t


def create_projection_matrix_h36m(K_list, R_list, t_list):
    """P = K·[R|t] per camera."""
    return [k @ np.hstack((r, t.reshape(-1, 1)))
            for k, r, t in zip(K_list, R_list, t_list)]


def get_camera_parameters_op(camera_data, nviews):
    """(K, R, t) dicts of a scene's Occlusion-Person cameras: the odd ones,
    with t = −R·T."""
    cameras = OP_CAMERAS[1::2][:nviews]
    K, R, t = {}, {}, {}
    for cam in cameras:
        cam = int(cam)
        c = camera_data[cam]
        K[cam] = np.array([[c["fx"], 0, c["cx"]],
                           [0, c["fy"], c["cy"]], [0, 0, 1]])
        R[cam] = np.array(c["R"], dtype=np.float64).reshape(3, 3)
        t[cam] = -R[cam] @ np.array(c["T"], dtype=np.float64).reshape(3, 1)
    return K, R, t


def get_camera_parameters_panoptic(camera_data, nviews):
    """(K, R, t) dicts of an activity's first ``nviews`` Panoptic cameras
    (t ×10: cm → mm)."""
    names = PANOPTIC_CAMERAS[:nviews]
    K, R, t = {}, {}, {}
    for cam in names:
        for data in camera_data["cameras"]:
            if data["name"] == cam:
                K[cam] = np.array(data["K"], dtype=np.float64).reshape(3, 3)
                R[cam] = np.array(data["R"], dtype=np.float64).reshape(3, 3)
                t[cam] = np.array(data["t"], dtype=np.float64).reshape(3, 1) * 10
    return K, R, t


def create_projection_matrix(K_dict, R_dict, t_dict):
    """P = K·[R|t] per camera, in sorted camera-key order."""
    return [K_dict[cam] @ np.hstack((R_dict[cam], t_dict[cam].reshape(-1, 1)))
            for cam in sorted(K_dict.keys())]


# ------------------------------- DLT solve --------------------------------

def _dlt_rows(P, poses_2d):
    """(…,V,3,4) projections and (…,V,N,2) detections → the (…,N,2V,4) DLT
    systems: rows x·P₂ − P₀ and y·P₂ − P₁ per view."""
    x = poses_2d[..., 0].transpose(-1, -2)[..., None]      # (…,N,V,1)
    y = poses_2d[..., 1].transpose(-1, -2)[..., None]
    P = P.unsqueeze(-4)                                      # (…,1,V,3,4)
    r0 = x * P[..., 2, :] - P[..., 0, :]                     # (…,N,V,4)
    r1 = y * P[..., 2, :] - P[..., 1, :]
    A = torch.stack([r0, r1], dim=-2)                        # (…,N,V,2,4)
    return A.reshape(A.shape[:-3] + (-1, 4))


def _null_vector(A):
    """The right singular vector of each system's smallest singular value,
    normalized by its homogeneous coordinate."""
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    X = Vh[..., -1, :]
    return X / X[..., 3:4]


def triangulate_points_multi_camera(P_list, x_list, device="cuda"):
    """One point's DLT from its (2,) detections in each camera: (4,)
    homogeneous, last coordinate 1."""
    dev = resolve_device(device)
    P = torch.as_tensor(np.asarray(P_list), dtype=torch.float64, device=dev)
    x = torch.as_tensor(np.asarray(x_list)[:, None, :2], dtype=torch.float64,
                        device=dev)
    return _null_vector(_dlt_rows(P, x))[0]


def triangulate_poses(P_list, poses_2d, device="cuda"):
    """(V,N,2+) detections and V (3,4) projections → (N,4) homogeneous
    points (last coordinate 1), float64 on ``device``, every joint in one
    batched SVD."""
    dev = resolve_device(device)
    P = torch.as_tensor(np.asarray(P_list), dtype=torch.float64, device=dev)
    x = torch.as_tensor(np.asarray(poses_2d)[..., :2], dtype=torch.float64,
                        device=dev)
    return _null_vector(_dlt_rows(P, x))


# ------------------------------ scene sweep --------------------------------

def run_triangulation(dataset_cfg, dataset_loader, output_dir, log=None,
                      device="cuda"):
    """Triangulate every scene of ``dataset_loader`` on ``device`` and
    write its iteration_0 cloud as a double-precision PLY."""
    dev = resolve_device(device)
    info = (log.info if log else print)
    data_root = dataset_cfg.data_root

    camera_data = None
    if "h36m" in data_root:
        meta = os.path.join(data_root, "3d_gt", "cameras",
                            "camera-parameters.json")
        if not os.path.exists(meta):
            meta = os.path.join(data_root, "initial_guess", "cameras",
                                "camera-parameters.json")
        with open(meta) as f:
            camera_data = json.load(f)
        K_cameras = get_calibration_matrices_h36m(camera_data)
    elif "occlusion-person" in data_root:
        with open(os.path.join(data_root, "cameras.json")) as f:
            camera_data = json.load(f)

    info(f"{len(dataset_loader)} scenes to process")
    pan_cal = {}
    out_dir = os.path.join(output_dir, "point_cloud", "iteration_0")
    os.makedirs(out_dir, exist_ok=True)

    for scene_id, rec in dataset_loader:
        scene_name = rec.scene_name
        subject_id = scene_name.split("_")[0]
        if "h36m" in data_root:
            R_c, t_c = get_extrinsics_h36m(camera_data, subject_id)
            P = create_projection_matrix_h36m(K_cameras, R_c, t_c)
        elif "occlusion-person" in data_root:
            K_c, R_c, t_c = get_camera_parameters_op(
                camera_data[str(scene_id)], dataset_cfg.nviews)
            P = create_projection_matrix(K_c, R_c, t_c)
        else:  # panoptic
            activity = scene_name.split("_")[1] + "_" + scene_name.split("_")[2]
            if activity not in pan_cal:
                path = os.path.join(data_root, "3d_gt", "cameras",
                                    f"calibration_{activity}.json")
                with open(path) as f:
                    pan_cal[activity] = json.load(f)
            K_c, R_c, t_c = get_camera_parameters_panoptic(
                pan_cal[activity], dataset_cfg.nviews)
            P = create_projection_matrix(K_c, R_c, t_c)

        X = triangulate_poses(P, rec.poses_2d, dev)
        pose_3d = (X[:, :3] / X[:, 3:4]).cpu().numpy()
        ply.write_xyz_double_ply(
            os.path.join(out_dir, f"{scene_name}.ply"), pose_3d)
    info(f"Wrote triangulated clouds to {out_dir}")

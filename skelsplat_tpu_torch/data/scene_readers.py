"""Scene-info readers and the ``sceneLoadTypeCallbacks`` registry
(counterpart of ``skelsplat_tpu/data/scene_readers.py``; numpy on the
host).

The three pose-dataset readers wrap a frame's pose and camera list into a
``SceneInfo``, round-tripping the pose through ``sparse/points3D.ply`` as
the reference does. The Colmap and Blender (NeRF-synthetic) readers are the
upstream-3DGS surface, on the package's own COLMAP and PLY IO.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.data import colmap, ply
from skelsplat_tpu_torch.data.cameras_io import CameraInfo


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str
    is_nerf_synthetic: bool
    scene_name: str = ""
    poses_2d: np.ndarray | None = None
    bboxes: np.ndarray | None = None


def fetchPly(path):
    """A point cloud PLY (xyz, rgb, normals) as a ``BasicPointCloud``,
    colours in [0, 1]."""
    d = ply.read_ply(path)
    positions = np.stack([d["x"], d["y"], d["z"]], 1)
    colors = np.stack([d["red"], d["green"], d["blue"]], 1) / 255.0
    normals = np.stack([d["nx"], d["ny"], d["nz"]], 1)
    return BasicPointCloud(positions, colors, normals)


def storePly(path, xyz, rgb):
    ply.write_point_ply(path, xyz, rgb)


def getNerfppNorm(cam_info):
    """{"translate", "radius"}: minus the cameras' mean centre, and 1.1 ×
    their largest distance from it."""
    cam_centers = []
    for cam in cam_info:
        W2C = geometry.world2view(cam.R, cam.T)
        C2W = np.linalg.inv(W2C)
        cam_centers.append(C2W[:3, 3:4])
    cam_centers = np.hstack(cam_centers)
    center = np.mean(cam_centers, axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(cam_centers - center, axis=0,
                                     keepdims=True))
    return {"translate": -center.flatten(), "radius": diagonal * 1.1}


def _read_pose_scene(path, pose_3d, cameras, scene_name):
    """The body the three pose-dataset readers share."""
    ply_path = os.path.join(path, "sparse", "points3D.ply")
    xyz = np.asarray(pose_3d).reshape(-1, 3)
    rgb = np.ones_like(xyz) * 255
    storePly(ply_path, xyz, rgb)
    try:
        pcd = fetchPly(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(point_cloud=pcd, train_cameras=cameras,
                     test_cameras=[], nerf_normalization=getNerfppNorm(cameras),
                     ply_path=ply_path, is_nerf_synthetic=False,
                     scene_name=scene_name)


def readHuman36MSceneInfo(path, pose_3d, cameras, scene_name):
    return _read_pose_scene(path, pose_3d, cameras, scene_name)


def readPanopticSceneInfo(path, pose_3d, cameras, scene_name):
    return _read_pose_scene(path, pose_3d, cameras, scene_name)


def readOcclusionPersonSceneInfo(path, pose_3d, cameras, scene_name):
    return _read_pose_scene(path, pose_3d, cameras, scene_name)


def readColmapSceneInfo(path, images=None, depths="", eval=False,
                        train_test_exp=False, llffhold=8):
    """A COLMAP model under ``path/sparse/0`` (binary, else text): its
    undistorted (PINHOLE / SIMPLE_PINHOLE) cameras sorted by id, every
    ``llffhold``-th held out for test when ``eval``, and its points
    (written once to ``points3D.ply``)."""
    try:
        cam_extr = colmap.read_extrinsics_binary(
            os.path.join(path, "sparse/0", "images.bin"))
        cam_intr = colmap.read_intrinsics_binary(
            os.path.join(path, "sparse/0", "cameras.bin"))
    except Exception:
        cam_extr = colmap.read_extrinsics_text(
            os.path.join(path, "sparse/0", "images.txt"))
        cam_intr = colmap.read_intrinsics_text(
            os.path.join(path, "sparse/0", "cameras.txt"))

    cam_infos = []
    for key in cam_extr:
        extr = cam_extr[key]
        intr = cam_intr[extr.camera_id]
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
            cx, cy = intr.params[1], intr.params[2]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
            cx, cy = intr.params[2], intr.params[3]
        else:
            raise ValueError(f"camera model {intr.model}: only undistorted "
                             "(PINHOLE/SIMPLE_PINHOLE) is supported")
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        cam_infos.append(CameraInfo(uid=intr.id, R=R, T=T, K=K,
                                    width=intr.width, height=intr.height))
    cam_infos = sorted(cam_infos, key=lambda c: c.uid)

    if eval and llffhold:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3D_binary(
                os.path.join(path, "sparse/0/points3D.bin"))
        except Exception:
            xyz, rgb, _ = colmap.read_points3D_text(
                os.path.join(path, "sparse/0/points3D.txt"))
        storePly(ply_path, xyz, rgb)
    try:
        pcd = fetchPly(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=getNerfppNorm(train),
                     ply_path=ply_path, is_nerf_synthetic=False)


def readNerfSyntheticInfo(path, white_background=False, depths="",
                          eval=False, extension=".png"):
    """A Blender (NeRF-synthetic) scene from its transforms JSONs. No image
    is read, so each camera is 800×800 with the focal its field of view
    gives; without ``points3d.ply`` 100,000 random points are written."""
    def read_transforms(fname):
        infos = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            size = 800
            f_len = geometry.fov2focal(fovx, size)
            K = np.array([[f_len, 0, size / 2], [0, f_len, size / 2],
                          [0, 0, 1.0]])
            infos.append(CameraInfo(uid=idx, R=R, T=T, K=K, width=size,
                                    height=size))
        return infos

    train = read_transforms("transforms_train.json")
    test = read_transforms("transforms_test.json")
    if not eval:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        rgb = (shs * 0.28209479177387814 + 0.5) * 255
        storePly(ply_path, xyz, rgb)
    try:
        pcd = fetchPly(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=getNerfppNorm(train),
                     ply_path=ply_path, is_nerf_synthetic=True)


sceneLoadTypeCallbacks = {
    "Human36M": readHuman36MSceneInfo,
    "Panoptic": readPanopticSceneInfo,
    "Occlusion-Person": readOcclusionPersonSceneInfo,
    "Colmap": readColmapSceneInfo,
    "Blender": readNerfSyntheticInfo,
}

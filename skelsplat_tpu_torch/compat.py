"""State carried across from the JAX package, and the upstream-3DGS object
API.

The optimized state is the whole model (there are no learned weights), so
a scene moves between the packages as its parameters, cameras and GT spec.
Each converter takes either a mapping of field name → array or an object
with those fields as attributes (the JAX package's dataclasses and
NamedTuples, after ``np.asarray`` of each leaf).

``GaussianModel`` and ``Scene`` mirror the reference's public classes on
top of the functional core (``GaussianParams``, ``AdamGroups``), so code
written against the reference's object API ports mechanically; the
densify / prune family is ``ops/densify.py``.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core.cameras import Camera, camera_from_arrays
from skelsplat_tpu_torch.core.cameras import FIELDS as CAMERA_FIELDS
from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS, GaussianParams,
                                                init_params)
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.data.scene_readers import BasicPointCloud
from skelsplat_tpu_torch.engine.optim import AdamGroups, AdamState, OptConfig
from skelsplat_tpu_torch.ops.heatmaps import HeatmapSpec
from skelsplat_tpu_torch.utils import searchForMaxIteration

_SPEC_INT_FIELDS = ("y0", "x0", "r1", "r2")


def _field(src, name):
    v = src[name] if isinstance(src, Mapping) else getattr(src, name)
    return np.asarray(v)


def params_from_numpy(src, device="cuda") -> GaussianParams:
    """GaussianParams from {xyz, log_scales, quats, opacity_logit}."""
    dev = resolve_device(device)
    return GaussianParams(*(
        torch.as_tensor(_field(src, f).astype(np.float32), device=dev)
        for f in PARAM_FIELDS))


def camera_from_numpy(src, device="cuda") -> Camera:
    """Camera (single or batched) from the Camera fields."""
    return camera_from_arrays({f: _field(src, f) for f in CAMERA_FIELDS},
                              device)


def spec_from_numpy(src, device="cuda") -> HeatmapSpec:
    """HeatmapSpec from its fields (index fields as int32, the rest f32)."""
    dev = resolve_device(device)
    return HeatmapSpec(*(
        torch.as_tensor(_field(src, f).astype(
            np.int32 if f in _SPEC_INT_FIELDS else np.float32), device=dev)
        for f in HeatmapSpec._fields))


class GaussianModel:
    """Mutable object over ``GaussianParams`` and ``AdamGroups`` on
    ``device``, with the reference's method names."""

    def __init__(self, sh_degree: int = 1, optimizer_type: str = "default",
                 device="cuda"):
        self.device = resolve_device(device)
        self.active_sh_degree = 0
        self.max_sh_degree = sh_degree
        self.optimizer_type = optimizer_type
        self.params: GaussianParams | None = None
        self.opt: AdamGroups | None = None
        self.opt_state: AdamState | None = None
        self.spatial_lr_scale = 0.0
        self._features_dc = None

    # activations
    @property
    def get_xyz(self):
        return self.params.xyz

    @property
    def get_scaling(self):
        return self.params.scales

    @property
    def get_rotation(self):
        return self.params.rotations

    @property
    def get_opacity(self):
        return self.params.opacity

    @property
    def get_features(self):
        return self._features_dc

    def get_covariance(self, scaling_modifier=1):
        return self.params.covariance(scaling_modifier)

    def oneupSHdegree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    # lifecycle
    def create_from_pcd(self, pcd, cam_infos, spatial_lr_scale: float,
                        opacity_on: bool, scaling: float, n_joints: int,
                        scaling_modifier: float = 1.0,
                        scene_type: str = "h36m"):
        """One Gaussian per point of ``pcd`` (``init_params``), with
        one-hot (N,1,N) features."""
        self.spatial_lr_scale = spatial_lr_scale
        self.params = init_params(np.asarray(pcd.points), scene_type,
                                  scaling, scaling_modifier,
                                  device=self.device)
        n = self.params.n_joints
        self._features_dc = torch.eye(n, device=self.device)[:, None, :]
        self.opacity_on = opacity_on

    def training_setup(self, training_args):
        """Adam over the parameter groups, with the learning rates of an
        ``optimization`` config group."""
        cfg = OptConfig(
            iterations=int(getattr(training_args, "iterations", 500)),
            position_lr_init=float(training_args.position_lr_init),
            position_lr_final=float(training_args.position_lr_final),
            position_lr_delay_mult=float(training_args.position_lr_delay_mult),
            position_lr_max_steps=int(training_args.position_lr_max_steps),
            feature_lr=float(training_args.feature_lr),
            opacity_lr=float(training_args.opacity_lr),
            scaling_lr=float(training_args.scaling_lr),
            rotation_lr=float(training_args.rotation_lr),
        )
        self.opt = AdamGroups(cfg)
        self.opt_state = self.opt.init(self.params)

    def _iteration(self, iteration):
        return torch.full((), iteration, dtype=torch.int32,
                          device=self.device)

    def update_learning_rate(self, iteration):
        """The xyz LR at ``iteration`` (the optimizer applies it at step
        time)."""
        return float(self.opt.xyz_lr(self._iteration(iteration),
                                     self.spatial_lr_scale))

    def step(self, grads: GaussianParams, iteration: int):
        """One Adam step with ``grads`` at ``iteration`` (1-based)."""
        self.params, self.opt_state = self.opt.step(
            self.params, grads, self.opt_state, self._iteration(iteration),
            self.spatial_lr_scale)

    # checkpointing
    def capture(self):
        return (self.active_sh_degree, self.params, self.opt_state,
                self.spatial_lr_scale)

    def restore(self, model_args, training_args):
        (self.active_sh_degree, self.params, opt_state,
         self.spatial_lr_scale) = model_args
        self.training_setup(training_args)
        self.opt_state = opt_state

    def save_ply(self, path):
        p = self.params.map(lambda t: t.detach().cpu().numpy())
        ply.write_gaussian_ply(path, p.xyz, p.log_scales, p.quats,
                               p.opacity_logit)

    def load_ply(self, path, use_train_test_exp=False):
        g = ply.read_gaussian_ply(path)
        self.params = GaussianParams(*(
            torch.as_tensor(np.asarray(g[f], np.float32), device=self.device)
            for f in PARAM_FIELDS))
        if g["features_dc"] is not None:
            self._features_dc = torch.as_tensor(
                g["features_dc"], device=self.device)[:, None, :]
        self.active_sh_degree = self.max_sh_degree


class Scene:
    """Per-frame scene assembly: writes the initial pose's clouds and
    cameras.json under ``output_dir``, and seeds ``gaussians`` from the
    pose (or loads a saved iteration)."""

    def __init__(self, dataset, model, gaussians: GaussianModel,
                 initial_guess_3d, cameras, scene_name, output_dir,
                 load_iteration=None):
        from skelsplat_tpu_torch.core.gaussians import N_JOINTS, scene_type_of
        from skelsplat_tpu_torch.data import cameras_io
        from skelsplat_tpu_torch.engine.trainer import extent_from_centers

        self.model_path = output_dir
        self.gaussians = gaussians
        self.scene_name = scene_name
        self.poses_3d = initial_guess_3d
        self.cameras = cameras
        self.scene_type = dataset.data_root.split("/")[-1]
        self.loaded_iter = None

        stype = scene_type_of(dataset.data_root)
        self.n_joints = N_JOINTS[stype]

        if load_iteration:
            if load_iteration == -1:
                self.loaded_iter = searchForMaxIteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration

        xyz = np.asarray(initial_guess_3d, np.float32).reshape(-1, 3)
        rgb = np.ones_like(xyz) * 255
        ply.write_point_ply(os.path.join(output_dir, "sparse", "points3D.ply"),
                            xyz, rgb)
        ply.write_point_ply(os.path.join(output_dir, "input.ply"), xyz, rgb)
        with open(os.path.join(output_dir, "cameras.json"), "w") as f:
            json.dump([cameras_io.camera_to_json(i, c)
                       for i, c in enumerate(cameras)], f)

        self.camera_batch = cameras_io.build_camera_batch(
            cameras, device=gaussians.device)
        self.cameras_extent = extent_from_centers(
            np.stack([c.arrays()["cam_center"] for c in cameras]))

        if self.loaded_iter:
            self.gaussians.load_ply(os.path.join(
                self.model_path, "point_cloud",
                f"iteration_{self.loaded_iter}", "point_cloud.ply"))
        else:
            pcd = BasicPointCloud(xyz, rgb / 255.0, np.zeros_like(xyz))
            self.gaussians.create_from_pcd(
                pcd, cameras, self.cameras_extent,
                bool(getattr(model, "opacity_on", True)),
                float(model.scaling), self.n_joints,
                float(model.scaling_modifier), stype)

    def save_h36m(self, iteration, scene_name):
        self.gaussians.save_ply(os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}",
            f"{scene_name}.ply"))

    def save(self, iteration):
        self.gaussians.save_ply(os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}",
            "point_cloud.ply"))

    def getTrainCameras(self, scale=1.0):
        return self.camera_batch

    def getTestCameras(self, scale=1.0):
        return None

    def getSceneName(self, scene_idx=None):
        return self.scene_name

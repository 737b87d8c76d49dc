"""Skeletal Gaussian parameters as a dataclass of tensors (counterpart of
``skelsplat_tpu/core/gaussians.py``). The per-joint one-hot colours are not
stored: channel j only ever receives Gaussian j's α·T."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core import geometry

# Per-dataset extremity joints whose initial (log-)scale is multiplied by
# ``model.scaling_modifier``.
EXTREMITY_JOINTS = {
    "h36m": [3, 6, 12, 13, 15, 16],
    "panoptic": [8, 14, 4, 5, 10, 11],
    "occlusion-person": [3, 6, 10, 11, 13, 14],
}

N_JOINTS = {"h36m": 17, "panoptic": 19, "occlusion-person": 15}

# The reference initializes the opacity logit to +inf. A finite 40 gives the
# same fixed point without NaNs under autograd: sigmoid(40) rounds to 1.0f
# and its derivative s·(1−s) is exactly 0.0f.
OPACITY_INIT_LOGIT = 40.0

PARAM_FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Raw optimization parameters for N joints (leading batch axes allowed).

    xyz (N,3) means in world units; log_scales (N,3); quats (N,4)
    unnormalized (w,x,y,z); opacity_logit (N,1).
    """

    xyz: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logit: torch.Tensor

    def map(self, fn, *others: "GaussianParams") -> "GaussianParams":
        """``fn`` applied field by field to this and ``others``."""
        return GaussianParams(*(fn(getattr(self, f),
                                   *(getattr(o, f) for o in others))
                                for f in PARAM_FIELDS))

    @property
    def scales(self):
        return torch.exp(self.log_scales)

    @property
    def rotations(self):
        q = self.quats
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    @property
    def opacity(self):
        return torch.sigmoid(self.opacity_logit)

    def covariance(self, scale_modifier: float = 1.0):
        """(…,N,6) packed world covariance."""
        return geometry.build_cov3d(self.scales, self.quats, scale_modifier)

    @property
    def n_joints(self) -> int:
        return self.xyz.shape[-2]


def init_params(initial_pose, scene_type: str, scaling: float,
                scaling_modifier: float = 1.0, device="cuda") -> GaussianParams:
    """Seed parameters from an (…,N,3) initial pose (leading scene axes
    allowed; a flat (3N,) pose is one scene): means = the pose, log-scales
    = ``scaling`` (extremity joints × ``scaling_modifier``), identity
    quaternions, opacity pinned at 1. ``scaling <= 0`` uses the point
    coordinates as raw scales, as the reference does. The pose is numpy or
    a tensor (on ``device`` already, as a packed transfer leaves it); the
    parameters are new tensors either way. The constants are made on the
    device (fills, no host copy), so the call can be captured."""
    dev = resolve_device(device)
    if isinstance(initial_pose, torch.Tensor):
        xyz = initial_pose.detach().to(dev, torch.float32)
    else:
        xyz = torch.as_tensor(np.asarray(initial_pose, dtype=np.float32),
                              device=dev)
    lead = tuple(xyz.shape[:-2]) if xyz.dim() > 1 else ()
    xyz = xyz.reshape(lead + (-1, 3)).clone()
    n = xyz.shape[-2]

    def full(width, value):
        return torch.full(lead + (n, width), value, dtype=torch.float32,
                          device=dev)

    if scaling > 0.0:
        scales = full(3, scaling)
        # the extremity value as numpy rounds it: scaling in float32, times
        # the modifier in float32
        boost = np.full((1,), scaling, dtype=np.float32)
        boost *= scaling_modifier
        for i in EXTREMITY_JOINTS.get(scene_type, []):
            if i < n:
                scales[..., i, :].fill_(float(boost[0]))
    else:
        scales = xyz.clone()
    quats = full(4, 0.0)
    quats[..., 0].fill_(1.0)
    return GaussianParams(xyz, scales, quats, full(1, OPACITY_INIT_LOGIT))


def one_hot_features(n_joints: int, device="cuda") -> torch.Tensor:
    """The (N,N) one-hot joint-identity features: the dense renderer's
    colors. The kernel renderer never materializes them."""
    return torch.eye(n_joints, dtype=torch.float32,
                     device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class SkeletonModel:
    """Static per-dataset model description."""

    scene_type: str                 # "h36m" | "panoptic" | "occlusion-person"
    n_joints: int
    scaling: float = 3.0
    scaling_modifier: float = 1.0
    opacity_on: bool = True

    @classmethod
    def for_dataset(cls, data_root: str, scaling: float = 3.0,
                    scaling_modifier: float = 1.0, opacity_on: bool = True):
        """The model of the dataset that ``data_root`` names."""
        scene_type = scene_type_of(data_root)
        return cls(scene_type, N_JOINTS[scene_type], scaling, scaling_modifier,
                   opacity_on)

    def init(self, initial_pose, device="cuda") -> GaussianParams:
        """This model's initial parameters from an (…,N,3) pose."""
        return init_params(initial_pose, self.scene_type, self.scaling,
                           self.scaling_modifier, device=device)


def scene_type_of(data_root: str) -> str:
    """The dataset a path names, by substring. Order matters: 'h36m-occ'
    contains 'h36m'."""
    if "panoptic" in data_root:
        return "panoptic"
    if "occlusion-person" in data_root:
        return "occlusion-person"
    if "h36m" in data_root:
        return "h36m"
    raise ValueError(f"Could not recognize scene type from {data_root!r}")

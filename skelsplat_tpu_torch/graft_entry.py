"""The single-device forward check (counterpart of the root
``__graft_entry__.entry``).

``entry()`` returns ``(forward, (initial_pose,))``: ``forward`` is the mean
fused view loss (render + GT heatmap + masked loss, ``ops/fused.py``) over
the four views of one 512×512, 17-joint H36M-style scene, from its initial
pose. It is the inner function of the scene optimizer. It makes no host
copy and no host sync, so it can be captured as a CUDA graph.
``dryrun_multichip`` lives in ``parallel/dryrun.py``.
"""

from __future__ import annotations

import torch

from skelsplat_tpu_torch.core.cameras import camera_from_arrays
from skelsplat_tpu_torch.core.gaussians import (GaussianParams,
                                                SkeletonModel, init_params)
from skelsplat_tpu_torch.engine.trainer import TrainSettings
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.ops.fused import make_fused_view_loss
from skelsplat_tpu_torch.synthetic import synthetic_inputs

SIZE = 512


def _synthetic_inputs(n_scenes: int, width: int, height: int, n_views=4,
                      n_joints=17, device="cuda"):
    """(init (S,N,3), gt (S,N,3), p2d (S,V,N,2) numpy, cameras): the JAX
    entry's seeded ring of cameras, skeletons and detections, with the
    cameras on ``device``."""
    init, gt, p2d, cams = synthetic_inputs(n_scenes, width, height, n_views,
                                           n_joints)
    return init, gt, p2d, camera_from_arrays(cams, device)


def scene_forward(width: int, height: int, device="cuda"):
    """``entry``'s forward and example arguments at a ``width``×``height``
    frame."""
    init, _, p2d, cams = _synthetic_inputs(1, width, height, device=device)
    model = SkeletonModel("h36m", 17, scaling=3.0)
    view_loss = make_fused_view_loss(model, TrainSettings(), width, height)
    pose = torch.as_tensor(init[0], device=cams.view4.device)
    # the leaves that do not depend on the pose, made once on the device
    const = init_params(pose, model.scene_type, model.scaling,
                        model.scaling_modifier, device=pose.device)
    p2d = torch.as_tensor(p2d[0], device=pose.device)
    drop = torch.zeros(p2d.shape[:2], dtype=torch.bool, device=pose.device)

    def forward(initial_pose: torch.Tensor) -> torch.Tensor:
        params = GaussianParams(initial_pose.reshape(-1, 3),
                                const.log_scales, const.quats,
                                const.opacity_logit)
        spec = hm.heatmap_spec(params.xyz, params.covariance(), p2d, cams,
                               width, height, drop_mask=drop)
        return torch.mean(view_loss(params, cams, spec, p2d))

    return forward, (pose,)


def entry(device="cuda"):
    """(forward, example_args) for the single-device check, at 512×512."""
    return scene_forward(SIZE, SIZE, device)

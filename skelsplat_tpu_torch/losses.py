"""Loss registry (counterpart of ``skelsplat_tpu/losses.py``), the masked
heatmap losses and the limb-length consistency prior.

Heatmap losses take one or a batch of (…,C,H,W) renderings and reduce the
last three axes, returning ``(loss, error_map)``. Masked losses use the
union-of-support mask gt>0 | rendering>0 and divide by max(count, 1).
"""

from __future__ import annotations

import torch

_IMG = (-3, -2, -1)


def _masked(err, rendering, gt_heatmap, reduction):
    mask = (gt_heatmap > 0) | (rendering > 0)
    masked = torch.where(mask, err, torch.zeros_like(err))
    if reduction == "mean":
        cnt = torch.clamp(torch.sum(mask, dim=_IMG), min=1)
        return torch.sum(masked, dim=_IMG) / cnt
    if reduction == "sum":
        return torch.sum(masked, dim=_IMG)
    return masked


def l2_loss_gaussian(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                     reduction="mean", domain=None):
    """Masked MSE over the union of nonzero pixels; also returns the dense
    error map."""
    err = (rendering - gt_heatmap) ** 2
    return _masked(err, rendering, gt_heatmap, reduction), err


def l1_loss_gaussian(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                     reduction="mean", domain=None):
    err = torch.abs(rendering - gt_heatmap)
    return _masked(err, rendering, gt_heatmap, reduction), err


def l1_loss_masked(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                   reduction="mean", domain=None):
    err = torch.abs(rendering - gt_heatmap)
    return _masked(err, rendering, gt_heatmap, reduction), None


# limb endpoint joint-index pairs per dataset: (l_arm, r_arm, l_leg, r_leg)
LIMB_PAIRS = {
    "h36m": ((12, 13), (15, 16), (5, 6), (2, 3)),
    "panoptic": ((4, 5), (10, 11), (7, 8), (13, 14)),
    "occlusion-person": ((10, 11), (13, 14), (5, 6), (2, 3)),
}


def limb_3d_consistency_loss(gaussians_xyz, scene_type, reduction="mean"):
    """|‖l_arm‖−‖r_arm‖| + |‖l_leg‖−‖r_leg‖| limb-length symmetry prior of
    (…,N,3) joints."""
    la, ra, ll, rl = LIMB_PAIRS[scene_type]

    def limb(pair):
        d = gaussians_xyz[..., pair[0], :] - gaussians_xyz[..., pair[1], :]
        return torch.sqrt(torch.sum(d * d, dim=-1))

    return torch.abs(limb(la) - limb(ra)) + torch.abs(limb(ll) - limb(rl))


def no_consistency(gaussians_xyz, scene_type, reduction="mean"):
    return torch.zeros(gaussians_xyz.shape[:-2], dtype=torch.float32,
                       device=gaussians_xyz.device)


losses = {
    "l1_masked": l1_loss_masked,
    "l2_gaussian": l2_loss_gaussian,
    "l1_gaussian": l1_loss_gaussian,
}

consistency_losses = {
    "3D_length_consistency": limb_3d_consistency_loss,
    "none": no_consistency,
}

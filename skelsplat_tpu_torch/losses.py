"""Loss registry (counterpart of ``skelsplat_tpu/losses.py``): the thirteen
heatmap and soft-argmax losses and the limb-length consistency prior.

Heatmap losses take one or a batch of (…,C,H,W) renderings and reduce per
view, returning ``(loss, error_map)``: image maps over their last three
axes, soft-argmax keypoints (…,C,2) over their last two. Masked losses use
the union-of-support mask gt>0 | rendering>0 and divide by max(count, 1).

Every loss accepts ``domain=(width, height)``, each a scalar or a tensor
with the views' leading shape, giving each view's TRUE image extent where
the (C,H,W) maps are zero-padded to the rig's largest view (H36M mixes
1000- and 1002-wide cameras in one rig). Soft-argmax then keeps the pad
out of its softmax and counts coordinates in pixels of the true image,
and a plain "mean" over an image divides by C·height·width of the true
image. Masked losses need no domain: both maps are zero on the pad.
"""

from __future__ import annotations

import torch

_IMG = (-3, -2, -1)
_PTS = (-2, -1)


def _domain(domain, ref: torch.Tensor):
    """(width, height) as float32 tensors on ``ref``'s device."""
    return tuple(torch.as_tensor(d, dtype=torch.float32, device=ref.device)
                 for d in domain)


def softargmax2d(inp, beta=100, domain=None):
    """Spatial soft-argmax of (…,H,W) maps: softmax(β·x) over the H·W
    pixels, the expected pixel coordinates. Returns (…,2) as (col, row).

    Without ``domain`` the coordinates are the expectation of
    linspace(0, 1) grids scaled by (W−1, H−1). With ``domain=(wt, ht)``
    (per view: broadcast against the leading axes but the last, the
    channel axis), pixels outside the true extent get −inf logits, and the
    grids are the integer pixel indices, which on the true subimage equal
    the scaled linspace grids."""
    *lead, h, w = inp.shape
    dev = inp.device
    flat = inp.reshape(*lead, h * w)
    if domain is None:
        p = torch.softmax(beta * flat, dim=-1)
        rr = torch.linspace(0, 1, h, device=dev)[:, None].expand(h, w)
        cc = torch.linspace(0, 1, w, device=dev)[None, :].expand(h, w)
        result_r = torch.sum(p * rr.reshape(h * w), dim=-1) * (h - 1)
        result_c = torch.sum(p * cc.reshape(h * w), dim=-1) * (w - 1)
    else:
        wt, ht = _domain(domain, inp)
        rows = torch.arange(h, dtype=torch.float32, device=dev)
        cols = torch.arange(w, dtype=torch.float32, device=dev)
        # (…,1,H,W): one mask per view, shared by its channels
        inside = ((rows[:, None] < ht[..., None, None, None])
                  & (cols < wt[..., None, None, None]))
        inside = inside.reshape(*inside.shape[:-2], h * w)
        p = torch.softmax(
            torch.where(inside, beta * flat,
                        torch.full_like(flat, float("-inf"))), dim=-1)
        result_r = torch.sum(p * rows[:, None].expand(h, w).reshape(h * w),
                             dim=-1)
        result_c = torch.sum(p * cols[None, :].expand(h, w).reshape(h * w),
                             dim=-1)
    return torch.stack([result_c, result_r], dim=-1)


def _abs(x):
    """|x| whose derivative at 0 is +1, as JAX's ``abs`` (torch's is 0):
    the plain l1 loss ties at every pixel where both maps are 0."""
    return torch.where(x >= 0, x, -x)


def _reduce(x, reduction, axes, domain=None):
    """Reduce each view's ``axes`` of ``x`` (none for ``()``). With
    ``domain``, the "mean" of an image map (``axes`` the last three)
    divides by C·ht·wt of the view's true extent; ``x`` is zero on the
    pad."""
    if not axes or reduction not in ("mean", "sum"):
        return x
    if reduction == "mean":
        if domain is not None and len(axes) == 3:
            wt, ht = _domain(domain, x)
            return torch.sum(x, dim=axes) / (x.shape[-3] * ht * wt)
        return torch.mean(x, dim=axes)
    return torch.sum(x, dim=axes)


def _mask(rendering, gt_heatmap):
    return (gt_heatmap > 0) | (rendering > 0)


def _count(mask):
    return torch.clamp(torch.sum(mask, dim=_IMG), min=1)


def _masked(err, rendering, gt_heatmap, reduction):
    mask = _mask(rendering, gt_heatmap)
    masked = torch.where(mask, err, torch.zeros_like(err))
    if reduction == "mean":
        return torch.sum(masked, dim=_IMG) / _count(mask)
    if reduction == "sum":
        return torch.sum(masked, dim=_IMG)
    return masked


# --- heatmap-space losses ----------------------------------------------------

def l1_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0, reduction="mean",
            domain=None):
    return _reduce(_abs(rendering - gt_heatmap), reduction, _IMG,
                   domain), None


def l2_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0, reduction="mean",
            domain=None):
    pred = softargmax2d(rendering, domain=domain)
    return _reduce((pred - gt_2d) ** 2, reduction, _PTS), None


def l2_loss_gaussian(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                     reduction="mean", domain=None):
    """Masked MSE over the union of nonzero pixels; also returns the dense
    error map."""
    err = (rendering - gt_heatmap) ** 2
    return _masked(err, rendering, gt_heatmap, reduction), err


def l1_loss_gaussian(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                     reduction="mean", domain=None):
    err = _abs(rendering - gt_heatmap)
    return _masked(err, rendering, gt_heatmap, reduction), err


def l2_loss_gaussian_l1_loss_gaussian(rendering, gt_heatmap, gt_2d,
                                      lambda_loss=1.0, reduction="mean",
                                      domain=None):
    l2m, _ = l2_loss_gaussian(rendering, gt_heatmap, gt_2d, lambda_loss,
                              reduction="none")
    l1m, _ = l1_loss_gaussian(rendering, gt_heatmap, gt_2d, lambda_loss,
                              reduction="none")
    if reduction == "mean":
        cnt = _count(_mask(rendering, gt_heatmap))
        return ((1.0 - lambda_loss) * torch.sum(l2m, dim=_IMG) / cnt
                + lambda_loss * torch.sum(l1m, dim=_IMG) / cnt), None
    if reduction == "sum":
        return ((1.0 - lambda_loss) * torch.sum(l2m, dim=_IMG)
                + lambda_loss * torch.sum(l1m, dim=_IMG)), None
    return (1.0 - lambda_loss) * l2m + lambda_loss * l1m, None


def l2_loss_sqrt(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                 reduction="mean", domain=None):
    """The keypoints' Euclidean distance over every joint and both
    coordinates of a view: one number a view before any reduction."""
    pred = softargmax2d(rendering, domain=domain)
    loss = torch.sqrt(torch.sum((pred - gt_2d) ** 2, dim=_PTS))
    return _reduce(loss, reduction, ()), None


def huber_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0, delta=1.0,
               reduction="mean", domain=None):
    """The reference's huber: |e| ≤ δ → e², else |δ − |e|| − δ/2."""
    pred = softargmax2d(rendering, domain=domain)
    error = _abs(pred - gt_2d)
    loss = torch.where(error <= delta, error ** 2,
                       _abs(delta - error) - 0.5 * delta)
    return _reduce(loss, reduction, _PTS), None


def l1_l2_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
               reduction="mean", domain=None):
    if reduction == "mean":
        l1, _ = l1_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "mean",
                        domain)
        l2, _ = l2_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "mean",
                        domain)
        return (1.0 - lambda_loss) * l1 + lambda_loss * l2, None
    l1, _ = l1_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "none", domain)
    l2, _ = l2_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "none", domain)
    if reduction == "sum":
        return ((1.0 - lambda_loss) * torch.sum(l1, dim=_IMG)
                + lambda_loss * torch.sum(l2, dim=_PTS)), None
    return (1.0 - lambda_loss) * l1 + lambda_loss * l2, None


def l1_huber_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0, delta=1.0,
                  reduction="mean", domain=None):
    if reduction == "mean":
        l1, _ = l1_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "mean",
                        domain)
        hu, _ = huber_loss(rendering, gt_heatmap, gt_2d, lambda_loss, delta,
                           "mean", domain)
        return (1.0 - lambda_loss) * l1 + lambda_loss * hu, None
    l1, _ = l1_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "none", domain)
    hu, _ = huber_loss(rendering, gt_heatmap, gt_2d, lambda_loss, delta,
                       "none", domain)
    if reduction == "sum":
        return ((1.0 - lambda_loss) * torch.sum(l1, dim=_IMG)
                + lambda_loss * torch.sum(hu, dim=_PTS)), None
    return (1.0 - lambda_loss) * l1 + lambda_loss * hu, None


def l1_loss_masked(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                   reduction="mean", domain=None):
    err = _abs(rendering - gt_heatmap)
    return _masked(err, rendering, gt_heatmap, reduction), None


def _l1_masked_plus(rendering, gt_heatmap, point_loss, lambda_loss,
                    reduction):
    """(1−λ)·masked l1 + λ·``point_loss`` (…,C,2): the masked mean of the
    image term beside the plain mean of the keypoint term."""
    l1m, _ = l1_loss_masked(rendering, gt_heatmap, None, lambda_loss, "none")
    if reduction == "mean":
        cnt = _count(_mask(rendering, gt_heatmap))
        return ((1.0 - lambda_loss) * torch.sum(l1m, dim=_IMG) / cnt
                + lambda_loss * torch.mean(point_loss, dim=_PTS)), None
    if reduction == "sum":
        return ((1.0 - lambda_loss) * torch.sum(l1m, dim=_IMG)
                + lambda_loss * torch.sum(point_loss, dim=_PTS)), None
    return (1.0 - lambda_loss) * l1m + lambda_loss * point_loss, None


def l1_masked_l2_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                      reduction="mean", domain=None):
    l2, _ = l2_loss(rendering, gt_heatmap, gt_2d, lambda_loss, "none", domain)
    return _l1_masked_plus(rendering, gt_heatmap, l2, lambda_loss, reduction)


def l1_masked_huber_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                         delta=1.0, reduction="mean", domain=None):
    hu, _ = huber_loss(rendering, gt_heatmap, gt_2d, lambda_loss, delta,
                       "none", domain)
    return _l1_masked_plus(rendering, gt_heatmap, hu, lambda_loss, reduction)


def cauchy_loss(rendering, gt_heatmap, gt_2d, lambda_loss=1.0,
                reduction="mean", domain=None):
    pred = softargmax2d(rendering, domain=domain)
    residual = pred - gt_2d
    return _reduce(torch.log(1 + residual ** 2), reduction, _PTS), None


# --- 3D consistency losses ---------------------------------------------------

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
    "l1": l1_loss,
    "l2": l2_loss,
    "l2_sqrt": l2_loss_sqrt,
    "huber": huber_loss,
    "l1_l2": l1_l2_loss,
    "l1_huber": l1_huber_loss,
    "l1_masked": l1_loss_masked,
    "l1_masked_l2": l1_masked_l2_loss,
    "l1_masked_huber": l1_masked_huber_loss,
    "cauchy": cauchy_loss,
    "l2_gaussian": l2_loss_gaussian,
    "l2_gaussian_l1_gaussian": l2_loss_gaussian_l1_loss_gaussian,
    "l1_gaussian": l1_loss_gaussian,
}

consistency_losses = {
    "3D_length_consistency": limb_3d_consistency_loss,
    "none": no_consistency,
}


def __getattr__(name):
    # the early-stopping registry lives with the engine and is re-exported
    # here beside the loss registries (lazily, to avoid an import cycle)
    if name == "early_stopping_strategy":
        from skelsplat_tpu_torch.engine.early_stopping import (
            early_stopping_strategy)
        return early_stopping_strategy
    raise AttributeError(name)

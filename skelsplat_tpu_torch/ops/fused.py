"""Fused render + GT heatmap + masked loss, streamed over row chunks
(counterpart of ``skelsplat_tpu/ops/fused.py``).

For a batch of views it computes

    S = Σ_{c,y,x} mask·err(render − gt),  mask = (gt>0 | render>0) ∧ in-image
    C = Σ mask,   loss = S / max(C, 1)

chunk by chunk. Each chunk's (…,N,rows,W) intermediates are recomputed in
the backward pass (``torch.utils.checkpoint``), so no image-sized tensor
outlives its chunk. This is the autograd reference of the CUDA kernel
(ops/cuda_raster.py).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch.core.cameras import Camera
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.ops import rasterizer

# losses this path implements
FUSED_LOSSES = ("l2_gaussian", "l1_gaussian", "l1_masked")


def fused_view_loss_available(loss_function: str,
                              consistency_loss: str) -> bool:
    """Whether this path implements ``loss_function`` (every consistency
    loss is)."""
    return loss_function in FUSED_LOSSES


def _chunk_sums(pp: rasterizer.Preprocessed, spec: hm.HeatmapSpec, y0: int,
                rows: int, W: int, loss_function: str):
    """Per-view masked error sum and mask count over rows [y0, y0+rows)."""
    dev = pp.depth.device
    ys = y0 + torch.arange(rows, dtype=torch.int32, device=dev)
    xs = torch.arange(W, dtype=torch.int32, device=dev)
    in_img = ((ys[:, None] < spec.height[..., :1, None, None])
              & (xs < spec.width[..., :1, None, None]))
    contrib, order = rasterizer.composite_weights(
        pp, *rasterizer.pixel_offsets(pp, ys, xs))
    render = torch.clamp(rasterizer._unsort(contrib, order), 0.0, 1.0)

    p1 = hm._profile(ys, spec.y0[..., None], spec.sigma1[..., None],
                     spec.r1[..., None], spec.sum1[..., None],
                     spec.height[..., None])                  # (…,N,rows)
    p2 = hm._profile(xs, spec.x0[..., None], spec.sigma2[..., None],
                     spec.r2[..., None], spec.sum2[..., None],
                     spec.width[..., None])                   # (…,N,W)
    raw = spec.amp[..., None, None] * p1[..., :, None] * p2[..., None, :]
    mn = spec.mn[..., None, None]
    mx = spec.mx[..., None, None]
    gt = (raw - mn) / (mx - mn + hm.NORM_EPS)

    mask = ((gt > 0) | (render > 0)) & in_img
    if loss_function in ("l1_gaussian", "l1_masked"):
        err = torch.abs(render - gt)
    else:
        err = (render - gt) ** 2
    s = torch.sum(torch.where(mask, err, torch.zeros_like(err)), dim=(-3, -2, -1))
    c = torch.sum(mask, dim=(-3, -2, -1), dtype=torch.int32)
    return s, c


def fused_view_loss(params, cameras: Camera, spec: hm.HeatmapSpec, W: int,
                    H: int, loss_function: str = "l2_gaussian",
                    antialiasing: bool = False, rows_per_chunk: int = 64):
    """(V,) masked heatmap loss of a batch of views. ``params`` fields are
    (N,·) or per view (V,N,·); ``cameras`` and ``spec`` are batched over V."""
    cov6 = params.covariance()
    pp = rasterizer.preprocess_gaussians(
        params.xyz, cov6, params.opacity, cameras, W, H, antialiasing)
    S = torch.zeros(pp.depth.shape[:-1], dtype=torch.float32,
                    device=pp.depth.device)
    C = torch.zeros(pp.depth.shape[:-1], dtype=torch.int32,
                    device=pp.depth.device)
    for y0 in range(0, H, rows_per_chunk):
        # the chunk draws no random numbers: no RNG state to save and
        # restore around its recompute
        s, c = checkpoint(_chunk_sums, pp, spec, y0, rows_per_chunk, W,
                          loss_function, use_reentrant=False,
                          preserve_rng_state=False)
        S = S + s
        C = C + c
    return S / torch.clamp(C, min=1).to(torch.float32)


def make_fused_view_loss(model, settings, W: int, H: int,
                         antialiasing: bool = False):
    """Per-view total loss (heatmap term + λ·consistency) with the
    SceneTrainer's (params, cameras, view_aux, poses_2d) signature."""
    cons_fn = loss_registry.consistency_losses[settings.consistency_loss]

    def view_loss(params, cameras, spec, poses_2d):
        main = fused_view_loss(params, cameras, spec, W, H,
                               settings.loss_function, antialiasing)
        cons = cons_fn(params.xyz, model.scene_type, reduction="mean")
        return main + cons * settings.lambda_consistency

    return view_loss

"""The work K1 (the render-and-loss kernel with its gradient) needs, and
the least time the card could take for it: a frozen copy of
``skelsplat_tpu_torch/tools/roofline.py``'s ``PAIR_OPS``,
``tile_activity``, ``pair_work`` and ``kernel_bound`` (published peaks),
reckoned here from the cell's own inputs (frame size, views, joints and
the Gaussians as the frame starts them) and not from the program's
internal slot records. So the bound reads the same work whatever
implements K1.

Per view and Gaussian: its 16×16 tile rect (render work on every in-image
pixel of the tiles it covers) and its GT support, the pixels where the
truncated GT blur is non-zero (GT-only work on the support's pixels in
tiles the rect does not cover)."""

from __future__ import annotations

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s
# and f32 operations/s outside the tensor cores, an FMA counted as 2
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
TILE = 16
# K1's two kernels as the device trace names them: the live-tile list and
# the persistent grid over it; a call is one launch of each
KERNELS = ("live_tiles", "raster_loss_live")
N_GRAD = 6
PACK = 16
# (f32 operations, expf calls) a (pixel, Gaussian) pair needs: pass 1
# where the Gaussian's rect covers the tile, pass 1 where only its GT
# support meets it, pass 2 (the gradient) on pass 1's values
PAIR_OPS = {"pass1_render": (39, 1), "pass1_gt_only": (7, 0),
            "pass2": (33, 0)}


def pair_work(render_pairs: int, gt_only_pairs: int) -> tuple[int, int]:
    """(f32 operations, expf calls) over the given pairs, with the
    gradient."""
    r1, g1, p2 = (PAIR_OPS[k] for k in ("pass1_render", "pass1_gt_only",
                                        "pass2"))
    return (render_pairs * (r1[0] + p2[0]) + gt_only_pairs * g1[0],
            render_pairs * (r1[1] + p2[1]) + gt_only_pairs * g1[1])


def pairs(rect, live, spans, img, H: int, W: int) -> tuple[int, int]:
    """(render pairs, GT-only pairs) of V views: ``rect`` (V,N,4) [x0, y0,
    x1, y1) in tiles, ``live`` (V,N) bool (valid, opacity > 0), ``spans``
    (V,N,4) [y0, y1, x0, x1) the GT support in pixels, ``img`` (V,2) each
    view's (width, height)."""
    V, N = live.shape
    ty = np.arange(-(-H // TILE), dtype=np.float64).reshape(1, 1, -1, 1)
    tx = np.arange(-(-W // TILE), dtype=np.float64).reshape(1, 1, 1, -1)
    y0, x0 = ty * TILE, tx * TILE

    def col(a, k):
        return a[:, :, k].reshape(V, N, 1, 1).astype(np.float64)

    rend = (live.reshape(V, N, 1, 1) & (tx >= col(rect, 0))
            & (tx < col(rect, 2)) & (ty >= col(rect, 1))
            & (ty < col(rect, 3)))
    xlim = np.minimum(img[:, 0], W).reshape(V, 1, 1, 1)
    ylim = np.minimum(img[:, 1], H).reshape(V, 1, 1, 1)
    x_end = np.minimum(x0 + TILE, xlim)
    y_end = np.minimum(y0 + TILE, ylim)
    tile_px = np.clip(x_end - x0, 0, None) * np.clip(y_end - y0, 0, None)
    gt_px = (np.clip(np.minimum(x_end, col(spans, 3))
                     - np.maximum(x0, col(spans, 2)), 0, None)
             * np.clip(np.minimum(y_end, col(spans, 1))
                       - np.maximum(y0, col(spans, 0)), 0, None))
    return (int(np.where(rend, tile_px, 0).sum()),
            int(np.where(rend, 0, gt_px).sum()))


def call_bytes(V: int, N: int, H: int, W: int) -> int:
    """Bytes a call over V views must move at the least: each view's slot
    records, GT profiles and image size read once; its loss, count and
    gradients written once."""
    return 4 * (V * N * PACK + V * N * H + V * N * W + 2 * V
                + 2 * V + V * N * N_GRAD)


def frame_views(ref, init, p2d):
    """Per frame of (F,N,3) ``init``: (rect, live, spans, img) of its V
    views at the Gaussians it starts from, through the reference's
    geometry (``ref`` a ``reference.fit.Reference`` in float32)."""
    cfg = ref.cfg
    with torch.no_grad():
        xyz = torch.as_tensor(np.asarray(init, np.float32), device=ref.dev)
        p2d = torch.as_tensor(np.asarray(p2d, np.float32), device=ref.dev)
        F, N, _ = xyz.shape
        V = cfg["views"]
        log_s = np.full((N, 3), cfg["scaling"], np.float32)
        log_s[[j for j in cfg["extremity_joints"] if j < N]] = (
            np.float32(cfg["scaling"]) * np.float32(cfg["scaling_modifier"]))
        log_scales = torch.as_tensor(log_s, device=ref.dev).expand(F, N, 3)
        quats = torch.zeros((F, N, 4), device=ref.dev)
        quats[..., 0] = 1.0
        cov = ref.covariance(log_scales, quats)
        pix, _, _, radius, valid = ref.screen(
            xyz[:, None].expand(F, V, N, 3),
            cov[:, None].expand(F, V, N, 3, 3))
        rect = ref.tile_rects(pix, radius)
        area = (rect[..., 2] - rect[..., 0]) * (rect[..., 3] - rect[..., 1])
        live = valid & (area > 0)
        s_rows, s_cols = ref.gt_sigmas(xyz, cov)
        x0, y0 = ref.detections(p2d)
        r_rows = torch.floor(4.0 * s_rows + 0.5)
        r_cols = torch.floor(4.0 * s_cols + 0.5)
        h = ref.h.reshape(1, V, 1).to(torch.float32)
        w = ref.w.reshape(1, V, 1).to(torch.float32)
        spans = torch.stack([
            torch.clamp(y0 - r_rows, min=0), torch.minimum(y0 + r_rows + 1, h),
            torch.clamp(x0 - r_cols, min=0), torch.minimum(x0 + r_cols + 1, w),
        ], dim=-1)
        img = torch.stack([ref.w, ref.h], -1).to(torch.float32)
    return [(rect[f].cpu().numpy(), live[f].cpu().numpy(),
             spans[f].cpu().numpy(), img.cpu().numpy()) for f in range(F)]


def call_bound(views, H: int, W: int) -> dict:
    """The bound of one K1 call over ``views`` (a list of ``frame_views``
    entries, one call over all their views): operations, expf, bytes and
    (ms, "operations"|"bytes") against the published peaks."""
    render = gt_only = 0
    V = 0
    for rect, live, spans, img in views:
        r, g = pairs(rect, live, spans, img, H, W)
        render += r
        gt_only += g
        V += live.shape[0]
        N = live.shape[1]
    ops, expf = pair_work(render, gt_only)
    n_bytes = call_bytes(V, N, H, W)
    t_ops = (ops + expf) / PEAK_F32_PER_S * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {"ops": ops, "expf": expf, "bytes": n_bytes,
            "render_pairs": render, "gt_only_pairs": gt_only,
            "ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops > t_bytes else "bytes"}

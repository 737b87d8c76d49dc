"""Closed-form ground-truth heatmaps (counterpart of
``skelsplat_tpu/ops/heatmaps.py``).

The reference writes a 255-impulse at each detection and blurs it with an
anisotropic, truncated, reflect-padded ``gaussian_filter`` whose sigmas come
from the EWA-projected initial covariance. That image is the outer product
of two mirrored 1D truncated-Gaussian profiles, so it is evaluated here in
closed form at any pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.cameras import Camera
from skelsplat_tpu_torch.utils import PUT_ALIGN

TRUNCATE = 4.0     # scipy.ndimage.gaussian_filter default
AMPLITUDE = 255.0  # impulse value
NORM_EPS = 1e-8    # min-max normalization epsilon
# Bound on the truncation radius int(4σ+0.5); σ beyond D_MAX/4 ≈ 24 px is
# far outside this workload.
D_MAX = 96


def heatmap_sigmas_for_views(xyz, cov6, cameras: Camera):
    """(…,V,N) σ1/σ2 via the heatmap-convention EWA projection;
    ``cameras`` is batched over (…,V), ``xyz``/``cov6`` are (…,N,·): each
    scene's points seen by each of its views."""
    c = cameras.per_point()
    cov2d = geometry.ewa_cov2d_heatmap(xyz.unsqueeze(-3), cov6.unsqueeze(-3),
                                       c.view4, c.focal_x, c.focal_y,
                                       c.tan_fovx, c.tan_fovy)
    return geometry.heatmap_sigmas(cov2d)


class HeatmapSpec(NamedTuple):
    """Per-(view, joint) closed-form heatmap description, all (V,N).

    y0/x0: impulse pixel (int32, trunc-then-clamp of the detection); sigma1
    blurs rows, sigma2 columns; r*/sum* truncation radii (int32) and
    normalizers; mn/mx the per-channel extremes of the min-max
    normalization; amp the channel amplitude (0 when dropped out);
    width/height each view's true image size.
    """

    y0: torch.Tensor
    x0: torch.Tensor
    sigma1: torch.Tensor
    sigma2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    sum1: torch.Tensor
    sum2: torch.Tensor
    mn: torch.Tensor
    mx: torch.Tensor
    amp: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor

    def take(self, idx) -> "HeatmapSpec":
        """Views ``idx`` of the spec."""
        return HeatmapSpec(*(f[idx] for f in self))


def _kernel_sum(sigma, r):
    """Σ_{|d|≤r} exp(−d²/2σ²) of every (…,V,N) channel.

    The taps of each scene (each index of the axes before V and N) start
    at a ``PUT_ALIGN``-byte boundary of one buffer, where they would
    start in a tensor of the scene's own: on the card torch.sum rounds a
    row by its address (vectorized loads), so a batch's sums are bitwise
    each scene's own."""
    d = torch.arange(-D_MAX, D_MAX + 1, dtype=torch.float32,
                     device=sigma.device)
    w = torch.exp(-0.5 * (d / sigma[..., None]) ** 2)
    mask = torch.abs(d) <= r[..., None]
    per_scene = math.prod(w.shape[-3:])
    words = PUT_ALIGN // w.element_size()
    buf = torch.empty((math.prod(w.shape[:-3]),
                       -(-per_scene // words) * words),
                      dtype=torch.float32, device=sigma.device)
    taps = buf[:, :per_scene].view(w.shape)
    torch.where(mask, w, torch.zeros_like(w), out=taps)
    return torch.sum(taps, dim=-1)


def _wtap(d, sigma, r, s):
    """Normalized truncated kernel tap at integer offset d; 0 beyond r."""
    w = torch.exp(-0.5 * (d / sigma) ** 2) / s
    return torch.where(torch.abs(d) <= r, w, torch.zeros_like(w))


def _profile(y, y0, sigma, r, s, size):
    """Mirrored (reflect-mode) impulse-response profile at row/col ``y``:
    the impulse and its two nearest mirror images."""
    y = y.to(torch.float32)
    y0f = y0.to(torch.float32)
    return (_wtap(y - y0f, sigma, r, s)
            + _wtap(y + y0f + 1.0, sigma, r, s)
            + _wtap(y - (2.0 * size - 1.0 - y0f), sigma, r, s))


def heatmap_spec(xyz, cov6, poses_2d, cameras: Camera, W: int, H: int,
                 drop_mask=None) -> HeatmapSpec:
    """The closed-form spec for all (V,N) channels, or for (…,V,N) of a
    batch of scenes.

    xyz/cov6 (…,N,·) each scene's initial means and covariances; cameras
    batched over (…,V); poses_2d (…,V,N,2) detections in pixels; drop_mask
    optional (…,V,N) bool, True zeroes the channel (a tensor on the
    device, as the trainer passes it, is used as it is). W/H is the
    evaluation grid (the max over views); each view's true size comes from
    ``cameras.width/height`` (H36M mixes 1000- and 1002-wide cameras) and
    governs detection clamping, reflect mirrors and the normalization
    extremes.
    """
    dev = xyz.device
    sigma1, sigma2 = heatmap_sigmas_for_views(xyz, cov6, cameras)  # (…,V,N)
    w_v = cameras.width[..., None].to(torch.float32)                # (…,V,1)
    h_v = cameras.height[..., None].to(torch.float32)
    x0 = torch.clamp(torch.trunc(poses_2d[..., 0]), torch.zeros_like(w_v),
                     w_v - 1).to(torch.int32)
    y0 = torch.clamp(torch.trunc(poses_2d[..., 1]), torch.zeros_like(h_v),
                     h_v - 1).to(torch.int32)
    r1 = torch.clamp(torch.floor(TRUNCATE * sigma1 + 0.5), max=D_MAX
                     ).to(torch.int32)
    r2 = torch.clamp(torch.floor(TRUNCATE * sigma2 + 0.5), max=D_MAX
                     ).to(torch.int32)
    sum1 = _kernel_sum(sigma1, r1)
    sum2 = _kernel_sum(sigma2, r2)

    # The image is the outer product of two non-negative profiles, so its
    # min/max over each view's true domain factorize.
    ys = torch.arange(H, dtype=torch.int32, device=dev)
    xs = torch.arange(W, dtype=torch.int32, device=dev)
    p1 = _profile(ys, y0[..., None], sigma1[..., None], r1[..., None],
                  sum1[..., None], h_v[..., None])                # (…,V,N,H)
    p2 = _profile(xs, x0[..., None], sigma2[..., None], r2[..., None],
                  sum2[..., None], w_v[..., None])                # (…,V,N,W)
    in_h = ys < cameras.height[..., None, None]
    in_w = xs < cameras.width[..., None, None]
    amp = torch.full(sigma1.shape, AMPLITUDE, dtype=torch.float32, device=dev)
    if drop_mask is not None:
        amp = torch.where(torch.as_tensor(drop_mask, device=dev),
                          torch.zeros_like(amp), amp)
    # a float, not a host-made tensor: its copy to the card would block
    inf = float("inf")
    mn = (amp * torch.amin(torch.where(in_h, p1, inf), dim=-1)
          * torch.amin(torch.where(in_w, p2, inf), dim=-1))
    mx = (amp * torch.amax(torch.where(in_h, p1, -inf), dim=-1)
          * torch.amax(torch.where(in_w, p2, -inf), dim=-1))
    wv = w_v.expand(y0.shape).contiguous()
    hv = h_v.expand(y0.shape).contiguous()
    return HeatmapSpec(y0, x0, sigma1, sigma2, r1, r2, sum1, sum2, mn, mx,
                       amp, wv, hv)


def eval_heatmaps(spec: HeatmapSpec, W: int, H: int) -> torch.Tensor:
    """The full (V,N,H,W) normalized GT heatmap stack, zero outside each
    view's true image."""
    dev = spec.y0.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)
    xs = torch.arange(W, dtype=torch.int32, device=dev)
    p1 = _profile(ys, spec.y0[..., None], spec.sigma1[..., None],
                  spec.r1[..., None], spec.sum1[..., None],
                  spec.height[..., None])                            # (V,N,H)
    p2 = _profile(xs, spec.x0[..., None], spec.sigma2[..., None],
                  spec.r2[..., None], spec.sum2[..., None],
                  spec.width[..., None])                             # (V,N,W)
    raw = spec.amp[..., None, None] * p1[..., :, None] * p2[..., None, :]
    mn = spec.mn[..., None, None]
    mx = spec.mx[..., None, None]
    val = (raw - mn) / (mx - mn + NORM_EPS)
    inside = ((ys[:, None] < spec.height[..., None, None])
              & (xs[None, :] < spec.width[..., None, None]))
    return torch.where(inside, val, torch.zeros_like(val))


def eval_heatmap_channel(spec: HeatmapSpec, v, j, ys, xs, W: int, H: int):
    """Channel (v, j) of the normalized GT heatmap at integer pixel rows
    ``ys`` and columns ``xs`` (broadcastable tensors), zero outside the
    view's true image."""
    p1 = _profile(ys, spec.y0[v, j], spec.sigma1[v, j], spec.r1[v, j],
                  spec.sum1[v, j], spec.height[v, j])
    p2 = _profile(xs, spec.x0[v, j], spec.sigma2[v, j], spec.r2[v, j],
                  spec.sum2[v, j], spec.width[v, j])
    raw = spec.amp[v, j] * p1 * p2
    val = (raw - spec.mn[v, j]) / (spec.mx[v, j] - spec.mn[v, j] + NORM_EPS)
    inside = (ys < spec.height[v, j]) & (xs < spec.width[v, j])
    return torch.where(inside, val, torch.zeros_like(val))


def dropout_masks(generator: torch.Generator, n_views: int,
                  n_joints: int) -> torch.Tensor:
    """One scene's joint-dropout mask on the generator's device: 3 random
    cameras × 3 random joints zeroed, drawn by two ``torch.randint`` calls
    on ``generator``. The camera draw's range is 4 whatever ``n_views``, as
    the reference's is. Returns an (n_views, n_joints) bool tensor."""
    dev = generator.device
    cams = torch.randint(4, (3,), generator=generator, device=dev)
    joints = torch.randint(n_joints, (3,), generator=generator, device=dev)
    cam_hit = torch.any(
        torch.arange(n_views, device=dev)[:, None] == cams[None, :], dim=-1)
    joint_hit = torch.any(
        torch.arange(n_joints, device=dev)[:, None] == joints[None, :], dim=-1)
    return cam_hit[:, None] & joint_hit[None, :]


def dropout_masks_torch(n_views: int, n_joints: int,
                        generator: torch.Generator) -> np.ndarray:
    """``dropout_masks`` drawn on a CPU generator (the driver's, which the
    caller seeds to 0 and draws from one scene at a time, in dataset
    order), as a host (n_views, n_joints) bool array."""
    return dropout_masks(generator, n_views, n_joints).numpy()


def generate_heatmaps_scipy(xyz, cov6, poses_2d, cameras: Camera,
                            W: int, H: int, drop_mask=None) -> np.ndarray:
    """The reference's GT heatmaps as it builds them, the oracle of the
    closed form: a 255-impulse at each detection blurred by
    ``scipy.ndimage.gaussian_filter`` with the EWA sigmas, min-max
    normalized per channel over the view's true image. (V,N,H,W) float32
    on the host; ``xyz`` (N,3) and ``cov6`` (N,6) tensors on the cameras'
    device."""
    from scipy.ndimage import gaussian_filter

    with torch.no_grad():
        s1, s2 = heatmap_sigmas_for_views(xyz, cov6, cameras)
    s1, s2 = s1.cpu().numpy(), s2.cpu().numpy()
    poses_2d = np.asarray(torch.as_tensor(poses_2d).cpu())
    widths = cameras.width.cpu().numpy().astype(int).reshape(-1)
    heights = cameras.height.cpu().numpy().astype(int).reshape(-1)
    if drop_mask is not None:
        drop_mask = np.asarray(torch.as_tensor(drop_mask).cpu())
    V, N = s1.shape
    out = np.zeros((V, N, H, W), dtype=np.float32)
    for v in range(V):
        w_v, h_v = widths[v], heights[v]
        x0 = np.clip(np.trunc(poses_2d[v, :, 0]).astype(np.int64), 0, w_v - 1)
        y0 = np.clip(np.trunc(poses_2d[v, :, 1]).astype(np.int64), 0, h_v - 1)
        hm_v = np.zeros((N, h_v, w_v), dtype=np.float32)
        for j in range(N):
            if drop_mask is not None and drop_mask[v, j]:
                continue
            img = np.zeros((h_v, w_v), dtype=np.float32)
            img[y0[j], x0[j]] = AMPLITUDE
            hm_v[j] = gaussian_filter(img, sigma=[s1[v, j], s2[v, j]])
        mn = hm_v.reshape(N, -1).min(axis=-1)[:, None, None]
        mx = hm_v.reshape(N, -1).max(axis=-1)[:, None, None]
        out[v, :, :h_v, :w_v] = (hm_v - mn) / (mx - mn + NORM_EPS)
    return out

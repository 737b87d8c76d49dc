"""Closed-form ground-truth heatmaps (counterpart of
``skelsplat_tpu/ops/heatmaps.py``).

The reference writes a 255-impulse at each detection and blurs it with an
anisotropic, truncated, reflect-padded ``gaussian_filter`` whose sigmas come
from the EWA-projected initial covariance. That image is the outer product
of two mirrored 1D truncated-Gaussian profiles, so it is evaluated here in
closed form at any pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.cameras import Camera

TRUNCATE = 4.0     # scipy.ndimage.gaussian_filter default
AMPLITUDE = 255.0  # impulse value
NORM_EPS = 1e-8    # min-max normalization epsilon
# Bound on the truncation radius int(4σ+0.5); σ beyond D_MAX/4 ≈ 24 px is
# far outside this workload.
D_MAX = 96


def heatmap_sigmas_for_views(xyz, cov6, cameras: Camera):
    """(V,N) σ1/σ2 via the heatmap-convention EWA projection; ``cameras``
    is batched over V, ``xyz``/``cov6`` are (N,·)."""
    c = cameras.per_point()
    cov2d = geometry.ewa_cov2d_heatmap(xyz, cov6, c.view4, c.focal_x,
                                       c.focal_y, c.tan_fovx, c.tan_fovy)
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
    """Σ_{|d|≤r} exp(−d²/2σ²)."""
    d = torch.arange(-D_MAX, D_MAX + 1, dtype=torch.float32,
                     device=sigma.device)
    w = torch.exp(-0.5 * (d / sigma[..., None]) ** 2)
    mask = torch.abs(d) <= r[..., None]
    return torch.sum(torch.where(mask, w, torch.zeros_like(w)), dim=-1)


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
    """The closed-form spec for all (V,N) channels.

    poses_2d (V,N,2) detections in pixels; drop_mask optional (V,N) bool,
    True zeroes the channel. W/H is the evaluation grid (the max over
    views); each view's true size comes from ``cameras.width/height`` (H36M
    mixes 1000- and 1002-wide cameras) and governs detection clamping,
    reflect mirrors and the normalization extremes.
    """
    dev = xyz.device
    sigma1, sigma2 = heatmap_sigmas_for_views(xyz, cov6, cameras)  # (V,N)
    w_v = cameras.width.reshape(-1, 1).to(torch.float32)            # (V,1)
    h_v = cameras.height.reshape(-1, 1).to(torch.float32)
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
                  sum1[..., None], h_v[..., None])                  # (V,N,H)
    p2 = _profile(xs, x0[..., None], sigma2[..., None], r2[..., None],
                  sum2[..., None], w_v[..., None])                  # (V,N,W)
    in_h = ys < cameras.height.reshape(-1, 1, 1)
    in_w = xs < cameras.width.reshape(-1, 1, 1)
    amp = torch.full(sigma1.shape, AMPLITUDE, dtype=torch.float32, device=dev)
    if drop_mask is not None:
        amp = torch.where(torch.as_tensor(drop_mask, device=dev),
                          torch.zeros_like(amp), amp)
    inf = torch.tensor(float("inf"), device=dev)
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

"""Differentiable SSIM (counterpart of ``skelsplat_tpu/ops/ssim.py``).

Two variants, as in the reference:

* ``ssim``: the plain convolutional SSIM (11-tap Gaussian window, σ = 1.5,
  "same" padding), differentiated by autograd.
* ``fused_ssim`` / ``fused_ssim_map``: the fused-ssim package's SSIM, with
  "same" or "valid" padding and the cached-partials backward: the forward
  saves ∂m/∂μ1, ∂m/∂σ1² and ∂m/∂σ12, and the backward is three more
  separable convolutions of the incoming gradient with them, without
  autograd through the statistics. The gradient goes to img1 only; img2,
  the reference image, gets zeros.

Each window is two depthwise ``F.conv2d``s, (C,1,11,1) then (C,1,1,11),
``groups=C``. The package turns TF32 off for convolutions, so they run in
full f32 on the card, like the JAX package's ``Precision.HIGHEST``.
C1/C2 are the standard (0.01², 0.03²).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2
WINDOW = 11
SIGMA = 1.5


def _gaussian_window(window_size=WINDOW, sigma=SIGMA, device=None):
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _sep_conv(x, w1d, padding):
    """Depthwise separable convolution of NCHW ``x`` with the 1D window
    ``w1d`` along H, then along W; "same" pads each side by half the
    window, "valid" not at all."""
    c, k = x.shape[1], w1d.shape[0]
    pad = k // 2 if padding == "same" else 0
    kh = w1d.reshape(1, 1, k, 1).expand(c, 1, k, 1).contiguous()
    kw = w1d.reshape(1, 1, 1, k).expand(c, 1, 1, k).contiguous()
    x = F.conv2d(x, kh, padding=(pad, 0), groups=c)
    return F.conv2d(x, kw, padding=(0, pad), groups=c)


def _ssim_stats(img1, img2, padding):
    w = _gaussian_window(device=img1.device)
    mu1 = _sep_conv(img1, w, padding)
    mu2 = _sep_conv(img2, w, padding)
    s11 = _sep_conv(img1 * img1, w, padding) - mu1 * mu1
    s22 = _sep_conv(img2 * img2, w, padding) - mu2 * mu2
    s12 = _sep_conv(img1 * img2, w, padding) - mu1 * mu2
    return mu1, mu2, s11, s22, s12


def ssim(img1, img2, window_size=11, size_average=True):
    """Mean SSIM of CHW or NCHW float images in [0, 1] (per image with
    ``size_average`` false)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1, mu2, s11, s22, s12 = _ssim_stats(img1, img2, "same")
    num = (2 * mu1 * mu2 + C1) * (2 * s12 + C2)
    den = (mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2)
    ssim_map = num / den
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


class _FusedSSIMMap(torch.autograd.Function):
    """The SSIM map with the cached-partials backward."""

    @staticmethod
    def forward(ctx, img1, img2, padding):
        mu1, mu2, s11, s22, s12 = _ssim_stats(img1, img2, padding)
        A1 = 2 * mu1 * mu2 + C1
        A2 = 2 * s12 + C2
        B1 = mu1 * mu1 + mu2 * mu2 + C1
        B2 = s11 + s22 + C2
        m = (A1 * A2) / (B1 * B2)
        # cached partials of m = A1·A2 / (B1·B2):
        #   ∂m/∂μ1 = (2μ2·A2·B1 − 2μ1·A1·A2) / (B1²·B2)
        dm_dmu1 = (2 * mu2 * A2 * B1 - A1 * A2 * 2 * mu1) / (B1 * B1 * B2)
        dm_dsigma1_sq = -(A1 * A2) / (B1 * B2 * B2)
        dm_dsigma12 = (2 * A1) / (B1 * B2)
        ctx.padding = padding
        ctx.save_for_backward(img1, img2, mu1, mu2, dm_dmu1, dm_dsigma1_sq,
                              dm_dsigma12)
        return m

    @staticmethod
    def backward(ctx, g):
        img1, img2, mu1, mu2, dm_dmu1, dm_dsigma1_sq, dm_dsigma12 = \
            ctx.saved_tensors
        w = _gaussian_window(device=g.device)
        a = dm_dmu1 - 2 * mu1 * dm_dsigma1_sq - mu2 * dm_dsigma12
        b = 2 * dm_dsigma1_sq
        c = dm_dsigma12
        if ctx.padding == "valid":
            # the gradient lives on the cropped grid: zero-pad it (and the
            # partials) back before the "same" convolution, which is its
            # own transpose for the symmetric window
            pad = (WINDOW // 2,) * 4
            g, a, b, c = (F.pad(t, pad) for t in (g, a, b, c))
        # dL/dimg1 = conv(g·(∂m/∂μ1 − 2μ1·∂m/∂σ1² − μ2·∂m/∂σ12))
        #          + img1·conv(g·2∂m/∂σ1²) + img2·conv(g·∂m/∂σ12)
        dimg1 = (_sep_conv(g * a, w, "same")
                 + img1 * _sep_conv(g * b, w, "same")
                 + img2 * _sep_conv(g * c, w, "same"))
        return dimg1, torch.zeros_like(img2), None


def fused_ssim_map(img1, img2, padding="same"):
    """The NCHW SSIM map; its gradient flows to img1 only."""
    return _FusedSSIMMap.apply(img1, img2, padding)


def fused_ssim(img1, img2, padding="same", train=True):
    """Mean fused SSIM of CHW or NCHW images; img2 is the reference image,
    which gets no gradient."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return torch.mean(fused_ssim_map(img1, img2, padding))


def fast_ssim(img1, img2):
    return fused_ssim(img1, img2, padding="same")

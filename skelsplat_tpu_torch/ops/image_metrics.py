"""Image metrics (counterpart of ``skelsplat_tpu/ops/image_metrics.py``)."""

import torch


def mse(img1, img2):
    """(B, 1) mean squared error of each image of a batch."""
    return ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(
        dim=1, keepdim=True)


def psnr(img1, img2):
    """(B, 1) PSNR in dB of images in [0, 1]."""
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))

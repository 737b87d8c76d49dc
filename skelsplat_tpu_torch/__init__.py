"""PyTorch/CUDA port of skelsplat_tpu: multi-view 3D pose estimation by
optimizing one 3D Gaussian per joint against closed-form GT heatmaps.

The package mirrors ``skelsplat_tpu``'s layout (``core/``, ``ops/``,
``engine/``, ``losses.py``) so each module has an obvious counterpart. It
imports torch only: the hot path (render + GT heatmap + masked loss + its
analytic gradient, per view and macro step) is the hand-written CUDA kernel
in ``csrc/raster_loss.cu``, built by nvcc at first use
(``ops/_build.py``). Every entry point takes ``device=`` and defaults to
``"cuda"``; asking for the GPU on a host without one raises.
"""

from __future__ import annotations

import torch

# Every f32 product and convolution runs at full precision, whichever entry
# point imported the package: in TF32 (10-bit mantissa), geometry products
# lose ~0.3% of covariance accuracy, far above the sub-mm parity budget, and
# SSIM's and LPIPS's convolutions would part from the reference's f32 ones
# (cuDNN allows TF32 for convolutions by default).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device on a host without a
    usable GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev

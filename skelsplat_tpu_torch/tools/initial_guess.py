"""Monocular-3D fusion initial guess (counterpart of
``skelsplat_tpu/tools/initial_guess.py``).

Each camera's monocular 3D prediction is reprojected into every view; the
cameras are weighted per joint by the inverse of their mean reprojection
error and the per-joint 3D positions are averaged with those weights. The
arithmetic runs in torch float64 on ``device`` (default the card), with
the numpy original's contraction and reductions; results come back as
numpy for the npz writers. A zero reprojection error gives an infinite
weight and NaN poses for that joint, as in numpy, without raising.
"""

from __future__ import annotations

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _reprojection_errors(P, poses3d, det):
    """(V,3,4), (C,F,J,3), (V,F,J,2) float64 tensors → (F,C,J) errors."""
    hom = torch.cat([poses3d, torch.ones_like(poses3d[..., :1])], dim=-1)
    proj = torch.einsum("vij,cfkj->vcfki", P, hom)          # (V,C,F,J,3)
    uv = proj[..., :2] / proj[..., 2:3]
    l2 = torch.linalg.norm(uv - det[:, None], dim=-1)       # (V,C,F,J)
    return l2.mean(dim=0).permute(1, 0, 2)                  # (F,C,J)


def _weights(errors, dim):
    w = 1.0 / errors
    return w / w.sum(dim=dim, keepdim=True)


def reprojection_errors(poses3d_world, poses2d, projection_matrices,
                        device="cuda"):
    """(C,F,J,3) world poses per source camera, (C,F,J,2) detections
    indexed by view, C projection matrices → (F,C,J) mean-over-views
    reprojection error of each source camera's pose."""
    dev = resolve_device(device)
    return _reprojection_errors(_f64(projection_matrices, dev),
                                _f64(poses3d_world, dev),
                                _f64(poses2d, dev)).cpu().numpy()


def errors_to_weights(errors, axis=0, device="cuda"):
    """Inverse-error weights normalized to 1 along ``axis``."""
    dev = resolve_device(device)
    return _weights(_f64(errors, dev), axis).cpu().numpy()


def fuse_poses(poses3d_world, poses2d, projection_matrices, device="cuda"):
    """(C,F,J,3) + (C,F,J,2) + C×(3,4) → (F,J,3) fused poses."""
    dev = resolve_device(device)
    poses = _f64(poses3d_world, dev)
    errs = _reprojection_errors(_f64(projection_matrices, dev), poses,
                                _f64(poses2d, dev))
    w = _weights(errs, 1)                                   # (F,C,J)
    fused = torch.einsum("fcj,fcjd->fjd", w, poses.permute(1, 0, 2, 3))
    return fused.cpu().numpy()

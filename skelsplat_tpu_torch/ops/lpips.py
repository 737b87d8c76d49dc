"""LPIPS, the Learned Perceptual Image Patch Similarity (counterpart of
``skelsplat_tpu/ops/lpips.py``).

A frozen backbone's per-stage features are unit-normalized along channels,
squared-differenced, weighted by 1×1 "lin" layers and averaged over space;
the stages' scores sum to the distance. The three reference backbones,
VGG16, AlexNet and SqueezeNet 1.1, are layer specs that mirror torchvision's
feature extractors module for module, so the reference's 1-based
``targets`` apply as they are.

No pretrained weights ship with the package. ``LPIPS.from_npz`` reads the
JAX package's npz schema (``conv{i}_w``, ``conv{i}_b``, ``lin{i}_w``,
``net_type``), so a file that ``skelsplat_tpu.ops.lpips`` loads loads here
unchanged; ``random_weights`` gives correctly shaped random weights, the
same arrays as the JAX package's for the same seed; without weights,
``lpips`` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skelsplat_tpu_torch import resolve_device

# ("conv", out_c, kernel, stride, pad) / ("relu",) / ("maxpool", k, s) /
# ("fire", squeeze_c, expand1x1_c, expand3x3_c)   (squeezenet1_1)
_C = lambda o, k, s=1, p=None: ("conv", o, k, s, k // 2 if p is None else p)  # noqa: E731
_R = ("relu",)

BACKBONES = {
    "vgg": {
        # torchvision vgg16().features
        "layers": [_C(64, 3), _R, _C(64, 3), _R, ("maxpool", 2, 2),
                   _C(128, 3), _R, _C(128, 3), _R, ("maxpool", 2, 2),
                   _C(256, 3), _R, _C(256, 3), _R, _C(256, 3), _R,
                   ("maxpool", 2, 2),
                   _C(512, 3), _R, _C(512, 3), _R, _C(512, 3), _R,
                   ("maxpool", 2, 2),
                   _C(512, 3), _R, _C(512, 3), _R, _C(512, 3), _R],
        "targets": (4, 9, 16, 23, 30),
        "n_channels": (64, 128, 256, 512, 512),
    },
    "alex": {
        # torchvision alexnet().features
        "layers": [_C(64, 11, 4, 2), _R, ("maxpool", 3, 2),
                   _C(192, 5, 1, 2), _R, ("maxpool", 3, 2),
                   _C(384, 3), _R, _C(256, 3), _R, _C(256, 3), _R,
                   ("maxpool", 3, 2)],
        "targets": (2, 5, 8, 10, 12),
        "n_channels": (64, 192, 384, 256, 256),
    },
    "squeeze": {
        # torchvision squeezenet1_1().features
        "layers": [_C(64, 3, 2, 0), _R, ("maxpool", 3, 2),
                   ("fire", 16, 64, 64), ("fire", 16, 64, 64),
                   ("maxpool", 3, 2),
                   ("fire", 32, 128, 128), ("fire", 32, 128, 128),
                   ("maxpool", 3, 2),
                   ("fire", 48, 192, 192), ("fire", 48, 192, 192),
                   ("fire", 64, 256, 256), ("fire", 64, 256, 256)],
        "targets": (2, 5, 8, 10, 11, 12, 13),
        "n_channels": (64, 128, 256, 384, 384, 512, 512),
    },
}

# the ImageNet normalization of lpipsPyTorch's networks
_MEAN = np.array([-0.030, -0.088, -0.188], np.float32)
_STD = np.array([0.458, 0.448, 0.450], np.float32)


def _conv_shapes(net_type: str):
    """(out_c, in_c, k, k) of every conv in traversal order (a fire module
    contributes squeeze, expand1x1, expand3x3)."""
    shapes, in_c = [], 3
    for item in BACKBONES[net_type]["layers"]:
        if item[0] == "conv":
            _, o, k, s, p = item
            shapes.append((o, in_c, k, k))
            in_c = o
        elif item[0] == "fire":
            _, sq, e1, e3 = item
            shapes += [(sq, in_c, 1, 1), (e1, sq, 1, 1), (e3, sq, 3, 3)]
            in_c = e1 + e3
    return shapes


class LPIPS(nn.Module):
    """LPIPS with the weights as buffers named as the npz schema's keys
    (``conv{i}_w``, ``conv{i}_b``, ``lin{i}_w``), so ``state_dict`` is the
    npz's arrays. ``LPIPS(net_type, device)`` holds uninitialized weights:
    build one with ``from_numpy`` or ``from_npz``."""

    def __init__(self, net_type: str = "vgg", device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.net_type = net_type
        for i, shape in enumerate(_conv_shapes(net_type)):
            self.register_buffer(f"conv{i}_w", torch.empty(shape, device=dev))
            self.register_buffer(f"conv{i}_b",
                                 torch.empty(shape[0], device=dev))
        for i, c in enumerate(BACKBONES[net_type]["n_channels"]):
            self.register_buffer(f"lin{i}_w",
                                 torch.empty((1, c, 1, 1), device=dev))
        self.register_buffer("mean", torch.as_tensor(
            _MEAN, device=dev).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.as_tensor(
            _STD, device=dev).reshape(1, 3, 1, 1), persistent=False)

    @classmethod
    def from_numpy(cls, weights: dict, net_type: str = "vgg",
                   device="cuda") -> "LPIPS":
        """From {"conv_w": [...], "conv_b": [...], "lin_w": [...]} numpy
        arrays (``random_weights``' layout); shapes are checked."""
        model = cls(net_type, device)
        state = {}
        for key in ("conv_w", "conv_b", "lin_w"):
            stem, suffix = key.split("_")
            for i, a in enumerate(weights[key]):
                state[f"{stem}{i}_{suffix}"] = torch.as_tensor(
                    np.asarray(a, np.float32))
        model.load_state_dict(state)
        return model

    @classmethod
    def from_npz(cls, path: str, device="cuda") -> "LPIPS":
        """From an npz in the JAX package's schema (``net_type`` defaults
        to vgg when the file has none)."""
        with np.load(path) as data:
            net_type = str(data["net_type"]) if "net_type" in data else "vgg"
            n_conv = len(_conv_shapes(net_type))
            n_lin = len(BACKBONES[net_type]["targets"])
            weights = {
                "conv_w": [data[f"conv{i}_w"] for i in range(n_conv)],
                "conv_b": [data[f"conv{i}_b"] for i in range(n_conv)],
                "lin_w": [data[f"lin{i}_w"] for i in range(n_lin)]}
        return cls.from_numpy(weights, net_type, device)

    def _conv(self, h, i, stride, pad):
        return F.conv2d(h, getattr(self, f"conv{i}_w"),
                        getattr(self, f"conv{i}_b"), stride=stride,
                        padding=pad)

    def _features(self, x):
        """x: (B,3,H,W) in [-1,1]. The unit-normalized features of each
        target stage."""
        cfg = BACKBONES[self.net_type]
        h = (x - self.mean) / self.std
        feats, ci = [], 0
        for mod_i, item in enumerate(cfg["layers"], start=1):
            if item[0] == "conv":
                _, o, k, s, p = item
                h = self._conv(h, ci, s, p)
                ci += 1
            elif item[0] == "relu":
                h = F.relu(h)
            elif item[0] == "maxpool":
                _, k, s = item
                h = F.max_pool2d(h, k, s)
            else:  # fire: squeeze→relu, two expands→relu, channel concat
                sq = F.relu(self._conv(h, ci, 1, 0))
                e1 = F.relu(self._conv(sq, ci + 1, 1, 0))
                e3 = F.relu(self._conv(sq, ci + 2, 1, 1))
                h = torch.cat([e1, e3], dim=1)
                ci += 3
            if mod_i in cfg["targets"]:
                norm = torch.sqrt(torch.sum(h * h, dim=1, keepdim=True))
                feats.append(h / (norm + 1e-10))
            if len(feats) == len(cfg["targets"]):
                break
        return feats

    def forward(self, x, y):
        """(B,3,H,W) images in [-1,1] → (B,) LPIPS distances."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self._features(x),
                                       self._features(y))):
            w = getattr(self, f"lin{i}_w").reshape(1, -1, 1, 1)
            score = torch.sum((a - b) ** 2 * w, dim=1)
            total = total + torch.mean(score, dim=(1, 2))
        return total


def random_weights(net_type: str = "vgg", seed: int = 0) -> dict:
    """Correctly shaped random weights (the npz schema as code), the same
    numpy arrays as the JAX package's for the same seed. Not perceptually
    meaningful."""
    rng = np.random.default_rng(seed)
    conv_w, conv_b = [], []
    for shape in _conv_shapes(net_type):
        fan_in = shape[1] * shape[2] * shape[3]
        conv_w.append(rng.normal(0, 1 / np.sqrt(fan_in),
                                 shape).astype(np.float32))
        conv_b.append(rng.normal(0, 0.1, shape[0]).astype(np.float32))
    lin_w = [np.abs(rng.normal(0, 0.05, (1, c, 1, 1))).astype(np.float32)
             for c in BACKBONES[net_type]["n_channels"]]
    return {"conv_w": conv_w, "conv_b": conv_b, "lin_w": lin_w}


def save_npz(path: str, weights: dict, net_type: str = "vgg"):
    """Write ``weights`` (``random_weights``' layout) in the npz schema."""
    out = {"net_type": np.asarray(net_type)}
    for key in ("conv_w", "conv_b", "lin_w"):
        stem, suffix = key.split("_")
        for i, a in enumerate(weights[key]):
            out[f"{stem}{i}_{suffix}"] = np.asarray(a, np.float32)
    np.savez(path, **out)


def default_weights_path(net_type: str = "vgg") -> str | None:
    """Path of a committed weight npz (``ops/lpips_weights/{net}.npz``), or
    None."""
    path = os.path.join(os.path.dirname(__file__), "lpips_weights",
                        f"{net_type}.npz")
    return path if os.path.exists(path) else None


def lpips(x, y, net_type: str = "vgg", version: str = "0.1",
          weights_path: str | None = None):
    """(B,) LPIPS distances of (B,3,H,W) images in [-1,1], on their
    device, with the weights at ``weights_path`` or the committed ones."""
    if weights_path is None:
        weights_path = default_weights_path(net_type)
    if weights_path is None:
        raise RuntimeError(
            f"LPIPS needs pretrained weights: commit {net_type}.npz (the "
            "schema LPIPS.from_npz reads) under "
            "skelsplat_tpu_torch/ops/lpips_weights/, or pass weights_path=")
    return LPIPS.from_npz(weights_path, device=x.device)(x, y)

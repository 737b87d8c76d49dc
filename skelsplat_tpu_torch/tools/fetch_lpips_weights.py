"""Fetch and convert the LPIPS pretrained weights (counterpart of
``skelsplat_tpu/tools/fetch_lpips_weights.py``; run it on a machine with
network access).

The repository ships no pretrained tensors. This script downloads the
checkpoints LPIPS is defined with (torchvision's VGG16, AlexNet and
SqueezeNet 1.1 backbones and the LPIPS v0.1 lin layers) and writes them in
the npz schema ``ops/lpips.LPIPS.from_npz`` reads:

    python -m skelsplat_tpu_torch.tools.fetch_lpips_weights \
        [--out skelsplat_tpu_torch/ops/lpips_weights] [--nets vgg alex squeeze]

The conversion maps the raw state dicts directly (only ``torch.load``, no
torchvision): a state dict keeps registration order, so the 4-D
``features.*.weight`` tensors come in the traversal order of
``ops/lpips.BACKBONES`` (a fire module gives squeeze, expand1x1,
expand3x3). Every tensor is shape-checked before anything is written.

A torchvision checkpoint's file name carries the first 8 hex digits of its
SHA-256, which is checked; the lin files publish no digest, so theirs is
printed and stored in the npz (``lin_sha256``).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import urllib.request

import numpy as np

from skelsplat_tpu_torch.ops.lpips import BACKBONES, WEIGHTS_DIR, _conv_shapes

# torchvision's IMAGENET1K_V1 checkpoints; the 8-hex suffix is the sha256
# prefix
BACKBONE_URLS = {
    "vgg": "https://download.pytorch.org/models/vgg16-397923af.pth",
    "alex": "https://download.pytorch.org/models/alexnet-owt-7be5be79.pth",
    "squeeze":
        "https://download.pytorch.org/models/squeezenet1_1-b8a52dc0.pth",
}

# the LPIPS v0.1 lin-layer state dicts
LIN_URL = ("https://raw.githubusercontent.com/richzhang/"
           "PerceptualSimilarity/master/lpips/weights/v0.1/{net}.pth")


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _download(url: str) -> bytes:
    print(f"fetching {url}")
    with urllib.request.urlopen(url) as r:
        return r.read()


def _load_state_dict(data: bytes):
    import torch
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=True)


def convert_state_dicts(backbone_sd, lin_sd, net_type: str) -> dict:
    """Raw (torchvision backbone, LPIPS lin) state dicts, of tensors or
    numpy arrays, → the npz array dict of ``LPIPS.from_npz``."""
    shapes = _conv_shapes(net_type)
    out = {"net_type": np.asarray(net_type)}

    convs = [(k, v) for k, v in backbone_sd.items()
             if k.startswith("features.") and k.endswith(".weight")
             and getattr(v, "ndim", np.ndim(v)) == 4]
    if len(convs) != len(shapes):
        raise ValueError(
            f"{net_type}: expected {len(shapes)} convs in the backbone "
            f"state dict, found {len(convs)}")
    for i, (wkey, w) in enumerate(convs):
        w = np.asarray(w, np.float32)
        if w.shape != shapes[i]:
            raise ValueError(f"{net_type} conv{i} ({wkey}): shape "
                             f"{w.shape} != spec {shapes[i]}")
        b = np.asarray(backbone_sd[wkey[:-len("weight")] + "bias"],
                       np.float32)
        out[f"conv{i}_w"] = w
        out[f"conv{i}_b"] = b

    for i, c in enumerate(BACKBONES[net_type]["n_channels"]):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                    f"lin.{i}.1.weight"):
            if key in lin_sd:
                break
        else:
            raise ValueError(f"{net_type} lin{i}: no LinLayer key found "
                             f"(have {sorted(lin_sd)[:4]}...)")
        w = np.asarray(lin_sd[key], np.float32).reshape(1, -1, 1, 1)
        if w.shape[1] != c:
            raise ValueError(f"{net_type} lin{i}: {w.shape[1]} channels, "
                             f"spec says {c}")
        out[f"lin{i}_w"] = w
    return out


def fetch_one(net_type: str, out_dir: str) -> str:
    """Download, check, convert and write ``{out_dir}/{net_type}.npz``."""
    url = BACKBONE_URLS[net_type]
    blob = _download(url)
    digest = _sha256(blob)
    pin = url.rsplit("-", 1)[-1].split(".")[0]
    if not digest.startswith(pin):
        raise RuntimeError(f"{url}: sha256 {digest[:8]} != pinned {pin}")
    backbone_sd = _load_state_dict(blob)

    lin_blob = _download(LIN_URL.format(net=net_type))
    lin_sha = _sha256(lin_blob)
    print(f"  lin weights sha256: {lin_sha}")
    lin_sd = _load_state_dict(lin_blob)

    arrays = convert_state_dicts(backbone_sd, lin_sd, net_type)
    arrays["lin_sha256"] = np.asarray(lin_sha)
    path = os.path.join(out_dir, f"{net_type}.npz")
    np.savez(path, **arrays)
    print(f"  wrote {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=WEIGHTS_DIR)
    ap.add_argument("--nets", nargs="+", default=["vgg", "alex", "squeeze"],
                    choices=list(BACKBONE_URLS))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for net in args.nets:
        fetch_one(net, args.out)


if __name__ == "__main__":
    main()

"""Process set-up for the CLI and small file helpers (counterpart of
``skelsplat_tpu/utils.py``)."""

from __future__ import annotations

import dataclasses
import os
import random
import sys
from datetime import datetime

import numpy as np
import torch

from skelsplat_tpu_torch import tracing


def safe_state(silent: bool) -> torch.Generator:
    """Timestamp every stdout line (or drop them all when ``silent``), seed
    ``random`` and ``numpy`` to 0, and return a CPU ``torch.Generator``
    seeded 0: the driver draws the dropout masks from it, one scene at a
    time, so they equal the reference's draws from torch's global
    generator after ``torch.manual_seed(0)``. The global generator is left
    alone."""
    old_f = sys.stdout

    class F:
        def __init__(self, silent):
            self.silent = silent

        def write(self, x):
            if not self.silent:
                if x.endswith("\n"):
                    old_f.write(x.replace(
                        "\n", " [{}]\n".format(
                            datetime.now().strftime("%d/%m %H:%M:%S"))))
                else:
                    old_f.write(x)

        def flush(self):
            old_f.flush()

    sys.stdout = F(silent)
    random.seed(0)
    np.random.seed(0)
    return torch.Generator().manual_seed(0)


def pil_to_array(pil_image, resolution=None):
    """CHW float image in [0,1] from a PIL image (the reference does not
    resize either)."""
    arr = np.array(pil_image) / 255.0
    if arr.ndim == 3:
        return np.transpose(arr, (2, 0, 1))
    return arr[None, ...]


def mkdir_p(folder_path):
    os.makedirs(folder_path, exist_ok=True)


def searchForMaxIteration(folder):
    """The largest N of the ``*_N`` entries in ``folder``."""
    saved_iters = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved_iters)


# ---------------------------------------------------------------------------
# Trees of tensors, and the packed host-to-device copy
# ---------------------------------------------------------------------------

_LEAVES = (torch.Tensor, np.ndarray, np.generic)
# where a fresh allocation of the caching allocator starts: a leaf packed at
# such an offset is read (vector widths, library kernel choice) as a tensor
# of its own would be, so results stay bitwise those of separate copies
PUT_ALIGN = 512


def tree_map(fn, tree, *rest):
    """``fn`` applied to the leaves (tensors, numpy arrays and scalars) of
    ``tree`` and the matching leaves of ``rest``, rebuilding tuples, lists,
    named tuples and dataclasses; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, _LEAVES):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def stack_trees(trees):
    """One tree of same-structured ``trees``, every leaf stacked along a
    new leading axis where it lies: numpy leaves by numpy, tensors by
    torch on their device. A group of scenes' host inputs then goes to the
    device in one ``put_trees`` copy with a leading group axis."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)
    return tree_map(stack, *trees)


def put_trees(trees, device):
    """The trees with every host leaf (numpy array, numpy scalar, CPU
    tensor) on ``device``, all moved by ONE copy (counterpart of
    ``skelsplat_tpu/utils.py::put_trees``): the leaves are packed into one
    buffer, each at a ``PUT_ALIGN``-byte boundary, which is pinned and
    copied without blocking when ``device`` is a GPU. The device leaves are
    views of that copy; tensors already on a GPU stay put. Traced as the
    ``skelsplat.input_copy`` span, its bytes counted as ``input_bytes``."""
    with tracing.span("skelsplat.input_copy"):
        return _put_trees(trees, torch.device(device))


def _put_trees(trees, dev):
    packed = []   # (array, byte offset)
    size = 0

    def plan(x):
        nonlocal size
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu" or dev.type == "cpu":
                return x
            x = x.detach().numpy()
        a = np.asarray(x)
        if not a.flags.c_contiguous:
            a = a.copy()
        packed.append((a, size))
        size += -(-a.nbytes // PUT_ALIGN) * PUT_ALIGN
        return np.int64(len(packed) - 1)   # a leaf standing for the view

    planned = [tree_map(plan, t) for t in trees]
    host = torch.empty(size + PUT_ALIGN, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    base = -host.data_ptr() % PUT_ALIGN
    host = host[base:base + size]
    host_np = host.numpy()
    for a, at in packed:
        host_np[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    tracing.count("input_bytes", "put_trees", size)

    def view(i):
        if isinstance(i, torch.Tensor):
            return i
        a, at = packed[int(i)]
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        return buf[at:at + a.nbytes].view(dtype).reshape(a.shape)

    return [tree_map(view, t) for t in planned]

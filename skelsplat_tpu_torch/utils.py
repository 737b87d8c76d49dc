"""Process set-up for the CLI and small file helpers (counterpart of
``skelsplat_tpu/utils.py``)."""

from __future__ import annotations

import os
import random
import sys
from datetime import datetime

import numpy as np
import torch


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

"""State carried across from the JAX package as numpy arrays.

The optimized state is the whole model (there are no learned weights), so
a scene moves between the packages as its parameters, cameras and GT spec.
Each converter takes either a mapping of field name → array or an object
with those fields as attributes (the JAX package's dataclasses and
NamedTuples, after ``np.asarray`` of each leaf).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core.cameras import Camera, camera_from_arrays
from skelsplat_tpu_torch.core.cameras import FIELDS as CAMERA_FIELDS
from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS, GaussianParams
from skelsplat_tpu_torch.ops.heatmaps import HeatmapSpec

_SPEC_INT_FIELDS = ("y0", "x0", "r1", "r2")


def _field(src, name):
    v = src[name] if isinstance(src, Mapping) else getattr(src, name)
    return np.asarray(v)


def params_from_numpy(src, device="cuda") -> GaussianParams:
    """GaussianParams from {xyz, log_scales, quats, opacity_logit}."""
    dev = resolve_device(device)
    return GaussianParams(*(
        torch.as_tensor(_field(src, f).astype(np.float32), device=dev)
        for f in PARAM_FIELDS))


def camera_from_numpy(src, device="cuda") -> Camera:
    """Camera (single or batched) from the Camera fields."""
    return camera_from_arrays({f: _field(src, f) for f in CAMERA_FIELDS},
                              device)


def spec_from_numpy(src, device="cuda") -> HeatmapSpec:
    """HeatmapSpec from its fields (index fields as int32, the rest f32)."""
    dev = resolve_device(device)
    return HeatmapSpec(*(
        torch.as_tensor(_field(src, f).astype(
            np.int32 if f in _SPEC_INT_FIELDS else np.float32), device=dev)
        for f in HeatmapSpec._fields))

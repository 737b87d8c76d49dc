"""Kernel C, ``compose_adam`` (``csrc/compose_adam.cu``): a macro step
after kernel B in one launch (no counterpart in the JAX package, which
leaves it to XLA).

For every scene of the launch it composes the visited views' gradients
(xyz's mean over the A views, the other groups' last view), steps Adam's
four groups in place at the xyz LR of the step counter's iteration, and
writes the history: the losses row, and in a full history the telemetry
norms of the updated means. It then advances Adam's step counts and the
macro step counter, which it reads on the device.

The kernel runs on the card only. Its plain version is the torch
composite it replaces, ``engine/trainer.py::compose_macro`` with
``AdamGroups.step`` and the loop state's writes, which
``engine/trainer.py::compose_adam_step`` runs on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS, GaussianParams
from skelsplat_tpu_torch.ops import _build

WIDTHS = (3, 3, 4, 1)   # floats a Gaussian of each group
# the telemetry norms' largest distance from the torch composite's, in
# units in the last place: a 3-component sum whose order follows torch's
# reduction config; every other output is bitwise the composite's
NORM_ULPS = 2


def _check(name: str, t: torch.Tensor, dtype, numel: int, dev):
    if (t.dtype != dtype or t.numel() != numel or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"{numel} elements on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def compose_adam(params: GaussianParams, m: GaussianParams,
                 v: GaussianParams, t: torch.Tensor, step: torch.Tensor,
                 losses_v: torch.Tensor, grads_v: GaussianParams,
                 extent: torch.Tensor, losses_out: torch.Tensor,
                 err_out=None, err_rel_out=None, gt=None, *,
                 lr_init: float, lr_final: float, max_steps: int,
                 delay_steps: int, delay_mult: float, lrs, beta1: float,
                 beta2: float, eps: float):
    """One launch of kernel C on CUDA tensors, all written in place.

    ``params``, ``m`` and ``v`` hold S scenes of N Gaussians (fields
    (…,N,k), the scene axes flattened); ``t`` (…) is Adam's step count
    (int32) and ``step`` () the macro step counter k (int64);
    ``losses_v`` (…,A) and ``grads_v`` (…,A,N,k) the visited views', in
    visit order; ``extent`` (…) the xyz LR's scale. A block a scene; the
    launch advances ``step``, which no other launch may use meanwhile. ``losses_out``
    (…,rows,A) takes the losses at row 0 when ``err_out`` is None (a lean
    history), else at row k, with the norms of the updated means against
    ``gt`` (…,N,3) at row k of ``err_out`` and ``err_rel_out``
    (…,rows,N). The xyz LR is ``expon_lr`` of iteration k·A + A, from
    ``lr_init``, ``lr_final``, ``max_steps``, ``delay_steps`` and
    ``delay_mult``; ``lrs`` are the other three groups' (scaling,
    rotation, opacity); ``beta1``, ``beta2`` and ``eps`` are Adam's."""
    dev = losses_v.device
    if dev.type != "cuda":
        raise ValueError("kernel C runs on CUDA tensors; on the CPU "
                         "engine/trainer.py::compose_adam_step runs its "
                         "plain version")
    S, A = t.numel(), losses_v.shape[-1]
    N = params.xyz.shape[-2]
    rows = losses_out.shape[-2]
    f32 = torch.float32
    for tree, label in ((params, "params"), (m, "m"), (v, "v")):
        for f, w in zip(PARAM_FIELDS, WIDTHS):
            _check(f"{label}.{f}", getattr(tree, f), f32, S * N * w, dev)
    grads = grads_v.map(lambda g: g.contiguous())
    for f, w in zip(PARAM_FIELDS, WIDTHS):
        _check(f"grads_v.{f}", getattr(grads, f), f32, S * A * N * w, dev)
    _check("t", t, torch.int32, S, dev)
    _check("step", step, torch.int64, 1, dev)
    _check("losses_v", losses_v, f32, S * A, dev)
    _check("extent", extent, f32, S, dev)
    _check("losses_out", losses_out, f32, S * rows * A, dev)
    full = err_out is not None
    if full:
        for name, x in (("err_out", err_out), ("err_rel_out", err_rel_out)):
            _check(name, x, f32, S * rows * N, dev)
        _check("gt", gt, f32, S * N * 3, dev)
    ptrs = ([getattr(x, f).data_ptr() for x in (params, m, v)
             for f in PARAM_FIELDS]
            + [t.data_ptr(), step.data_ptr(), losses_v.data_ptr()]
            + [getattr(grads, f).data_ptr() for f in PARAM_FIELDS]
            + [extent.data_ptr(), gt.data_ptr() if full else None,
               losses_out.data_ptr()]
            + ([err_out.data_ptr(), err_rel_out.data_ptr()] if full
               else [None, None]))
    # the Python doubles torch rounds to float32 where it meets them
    consts = [float(x) for x in (
        delay_mult, 1 - delay_mult, 0.5 * math.pi, *lrs, beta1, 1.0 - beta1,
        beta2, 1.0 - beta2, eps)]
    _build.launch("compose_adam", dev, *ptrs, S, A, N, rows, float(lr_init),
                  float(lr_final), int(max_steps), int(delay_steps), *consts)

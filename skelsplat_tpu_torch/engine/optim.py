"""Per-group Adam with exponential-decay xyz LR (counterpart of
``skelsplat_tpu/engine/optim.py``), matching torch.optim.Adam:

  m ← β1·m + (1−β1)·g          v ← β2·v + (1−β2)·g²
  p ← p − lr · (m / (1−β1ᵗ)) / ( √(v / (1−β2ᵗ)) + ε ),   ε = 1e-15

The xyz group's lr is expon_lr at the optimizer step's iteration, scaled by
the scene extent. Written out by hand so the state is plain tensors and
the step stays on the device: no host sync, no Python branch on a value.

Parameters may carry leading scene axes (a batch of B scenes: fields
(B,N,·)); the step count, the iteration and the extent then carry the
same axes, one value per scene.
"""

from __future__ import annotations

import dataclasses

import torch

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.gaussians import GaussianParams

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The live subset of the ``optimization`` config group."""

    iterations: int = 500
    position_lr_init: float = 5e-4
    position_lr_final: float = 5e-6
    position_lr_delay_mult: float = 0.0
    position_lr_max_steps: int = 4000
    feature_lr: float = 0.0
    opacity_lr: float = 0.0
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    position_lr_delay_steps: int = 0


@dataclasses.dataclass(frozen=True)
class AdamState:
    m: GaussianParams   # first moments
    v: GaussianParams   # second moments
    t: torch.Tensor     # int32 step count


class AdamGroups:
    """Stateless operator; the state lives in AdamState."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params: GaussianParams) -> AdamState:
        # m and v are buffers of their own: a step may write them in place
        return AdamState(m=params.map(torch.zeros_like),
                         v=params.map(torch.zeros_like),
                         t=torch.zeros(params.xyz.shape[:-2],
                                       dtype=torch.int32,
                                       device=params.xyz.device))

    def xyz_lr(self, iteration, spatial_lr_scale=1.0):
        """expon LR at ``iteration`` (1-based) times the scene extent."""
        c = self.cfg
        return spatial_lr_scale * geometry.expon_lr(
            iteration, c.position_lr_init, c.position_lr_final,
            lr_delay_steps=c.position_lr_delay_steps,
            lr_delay_mult=c.position_lr_delay_mult,
            max_steps=c.position_lr_max_steps)

    def group_lrs(self, iteration, spatial_lr_scale=1.0) -> GaussianParams:
        """Each group's learning rate at ``iteration``: xyz's schedule as a
        tensor, the constant groups' as floats (a captured step keeps them
        as kernel arguments)."""
        c = self.cfg
        return GaussianParams(self.xyz_lr(iteration, spatial_lr_scale),
                              c.scaling_lr, c.rotation_lr, c.opacity_lr)

    def step(self, params: GaussianParams, grads: GaussianParams,
             state: AdamState, iteration: torch.Tensor,
             spatial_lr_scale=1.0) -> tuple[GaussianParams, AdamState]:
        """One Adam step; ``iteration`` is the (1-based) inner iteration at
        which the step fires (it sets the xyz LR). With leading scene axes
        on ``params``, ``iteration``, ``state.t`` and ``spatial_lr_scale``
        hold one value per scene (or one for all)."""
        t = state.t + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 - torch.pow(BETA1, tf)
        bc2 = 1.0 - torch.pow(BETA2, tf)
        lrs = self.group_lrs(iteration, spatial_lr_scale)

        def upd(p, g, m, v, lr):
            lr, b1, b2 = (_per_scene(x, p) for x in (lr, bc1, bc2))
            m = BETA1 * m + (1.0 - BETA1) * g
            v = BETA2 * v + (1.0 - BETA2) * g * g
            denom = torch.sqrt(v / b2) + EPS
            return p - lr * (m / b1) / denom, m, v

        out = [upd(*(getattr(x, f) for x in (params, grads, state.m, state.v,
                                             lrs)))
               for f in ("xyz", "log_scales", "quats", "opacity_logit")]
        new_p, new_m, new_v = (GaussianParams(*(o[k] for o in out))
                               for k in range(3))
        return new_p, AdamState(m=new_m, v=new_v, t=t)


def _per_scene(x, p: torch.Tensor):
    """A per-scene value (a tensor over the scene axes, or a float) shaped
    to broadcast against the (…,N,·) field ``p``."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.reshape(tuple(x.shape) + (1,) * (p.dim() - x.dim()))

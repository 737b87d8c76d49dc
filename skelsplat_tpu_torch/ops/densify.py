"""Adaptive density control of upstream 3DGS (counterpart of
``skelsplat_tpu/ops/densify.py``): clone, split, prune and opacity reset
as functions over (``GaussianParams``, ``AdamState``, ``DensifyAux``).

The pose path never calls them: the skeleton has exactly one Gaussian per
joint. Cloning, splitting and pruning change N, so they run on the host
between steps (numpy, with the split samples from a numpy generator) and
return tensors on the parameters' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS, GaussianParams
from skelsplat_tpu_torch.engine.optim import AdamState


@dataclasses.dataclass
class DensifyAux:
    """Screen-space gradient statistics of N Gaussians, on the host."""

    xyz_gradient_accum: np.ndarray   # (N,1)
    denom: np.ndarray                # (N,1)
    max_radii2D: np.ndarray          # (N,)

    @classmethod
    def zeros(cls, n):
        return cls(np.zeros((n, 1), np.float32), np.zeros((n, 1), np.float32),
                   np.zeros((n,), np.float32))


def _host(x) -> np.ndarray:
    """A tensor (on any device, in a graph or not) or array as numpy."""
    return torch.as_tensor(x).detach().cpu().numpy()


def _np(p: GaussianParams) -> dict:
    return {k: _host(getattr(p, k)) for k in PARAM_FIELDS}


def _params(d: dict, device) -> GaussianParams:
    return GaussianParams(*(torch.as_tensor(d[k], device=device)
                            for k in PARAM_FIELDS))


def _state(m: dict, v: dict, t: torch.Tensor, device) -> AdamState:
    return AdamState(m=_params(m, device), v=_params(v, device), t=t)


def add_densification_stats(aux: DensifyAux, viewspace_grad, radii,
                            visibility) -> DensifyAux:
    """Accumulate the screen-space gradient norms of the visible
    Gaussians and their largest radius."""
    vg, vis = _host(viewspace_grad), _host(visibility)
    norm = np.linalg.norm(vg[:, :2], axis=-1, keepdims=True)
    acc = aux.xyz_gradient_accum.copy()
    den = aux.denom.copy()
    acc[vis] += norm[vis]
    den[vis] += 1
    maxr = np.maximum(aux.max_radii2D, _host(radii) * vis)
    return DensifyAux(acc, den, maxr)


def densify_and_prune(params: GaussianParams, state: AdamState,
                      aux: DensifyAux, max_grad: float, min_opacity: float,
                      extent: float, max_screen_size, radii,
                      percent_dense: float = 0.01, rng=None):
    """Clone small high-gradient Gaussians, split large ones into two
    children drawn from the parent's covariance (scales / 1.6), and prune
    the split parents, the transparent ones and, with
    ``max_screen_size``, the oversized ones. New Gaussians start with zero
    Adam moments. Returns (params, state, aux)."""
    rng = rng or np.random.default_rng(0)
    dev = params.xyz.device
    p, m, v = _np(params), _np(state.m), _np(state.v)

    grads = aux.xyz_gradient_accum / np.maximum(aux.denom, 1e-12)
    grads = np.nan_to_num(grads, nan=0.0)
    g1 = np.linalg.norm(grads, axis=-1)
    scales = np.exp(p["log_scales"])
    max_scale = scales.max(axis=1)
    radii = _host(radii).astype(np.float32)

    clone_mask = (g1 >= max_grad) & (max_scale <= percent_dense * extent)
    split_mask = (g1 >= max_grad) & (max_scale > percent_dense * extent)

    def cat(d, mask, transform=None):
        out = {}
        for k, val in d.items():
            sel = val[mask]
            if transform is not None:
                sel = transform(k, sel)
            out[k] = np.concatenate([val, sel], axis=0)
        return out

    # clones copy verbatim; their optimizer state starts at zero
    p2 = cat(p, clone_mask)
    zero_new = lambda k, s: np.zeros_like(s)  # noqa: E731
    m2 = cat(m, clone_mask, zero_new)
    v2 = cat(v, clone_mask, zero_new)
    radii2 = np.concatenate([radii, radii[clone_mask]])
    split_mask2 = np.concatenate([split_mask,
                                  np.zeros(clone_mask.sum(), bool)])

    # splits: 2 children sampled from the parent's covariance
    N_SPLIT = 2
    idx = np.nonzero(split_mask2)[0]
    parent_prune = np.zeros(p2["xyz"].shape[0] + N_SPLIT * idx.size, bool)
    if idx.size:
        parent_scales = np.exp(p2["log_scales"][idx])
        q = p2["quats"][idx]
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        R = np.stack([geometry.qvec2rotmat(qq) for qq in qn])
        children = {k: [] for k in p2}
        mc = {k: [] for k in m2}
        vc = {k: [] for k in v2}
        for _ in range(N_SPLIT):
            samples = rng.normal(0.0, parent_scales)
            new_xyz = np.einsum("nij,nj->ni", R, samples) + p2["xyz"][idx]
            children["xyz"].append(new_xyz.astype(np.float32))
            children["log_scales"].append(
                np.log(parent_scales / (0.8 * N_SPLIT)).astype(np.float32))
            children["quats"].append(p2["quats"][idx])
            children["opacity_logit"].append(p2["opacity_logit"][idx])
            for k in m2:
                mc[k].append(np.zeros_like(m2[k][idx]))
                vc[k].append(np.zeros_like(v2[k][idx]))
        p2 = {k: np.concatenate([p2[k]] + children[k]) for k in p2}
        m2 = {k: np.concatenate([m2[k]] + mc[k]) for k in m2}
        v2 = {k: np.concatenate([v2[k]] + vc[k]) for k in v2}
        radii2 = np.concatenate([radii2] + [radii2[idx]] * N_SPLIT)
        parent_prune[idx] = True

    opacity = 1.0 / (1.0 + np.exp(-p2["opacity_logit"][:, 0]))
    prune = parent_prune | (opacity < min_opacity)
    if max_screen_size:
        big_vs = radii2 > max_screen_size
        big_ws = np.exp(p2["log_scales"]).max(axis=1) > 0.1 * extent
        prune |= big_vs | big_ws
    keep = ~prune
    p2 = {k: val[keep] for k, val in p2.items()}
    m2 = {k: val[keep] for k, val in m2.items()}
    v2 = {k: val[keep] for k, val in v2.items()}
    return (_params(p2, dev), _state(m2, v2, state.t, dev),
            DensifyAux.zeros(p2["xyz"].shape[0]))


def reset_opacity(params: GaussianParams, state: AdamState):
    """Clamp every opacity to ≤ 0.01 and zero the opacity group's Adam
    moments."""
    dev = params.xyz.device
    p, m, v = _np(params), _np(state.m), _np(state.v)
    opa = 1.0 / (1.0 + np.exp(-p["opacity_logit"]))
    new = np.minimum(opa, 0.01)
    p["opacity_logit"] = np.log(new / (1 - new)).astype(np.float32)
    m["opacity_logit"] = np.zeros_like(m["opacity_logit"])
    v["opacity_logit"] = np.zeros_like(v["opacity_logit"])
    return _params(p, dev), _state(m, v, state.t, dev)

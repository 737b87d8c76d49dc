"""Kernel C's routing and its plain version on the CPU.

``engine/trainer.py::compose_adam_step`` composes a macro step's
gradients, steps Adam and writes the loop state: one launch of kernel C
(``ops/compose_adam.py``) on CUDA tensors, the torch composite on CPU
tensors. Here the CPU path, driven over a scene's 125 macro steps, is held
bitwise to the macro step as it was written before kernel C
(``compose_macro`` with the visit-order gather, then the carry and history
copies); the trainer's routing is held to its three settings; and Adam's
fresh moments are held to buffers of their own. The kernel itself is
checked against the torch composite on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS, GaussianParams,
                                                SkeletonModel)
from skelsplat_tpu_torch.engine.optim import AdamGroups, OptConfig
from skelsplat_tpu_torch.engine.trainer import (SceneTrainer, TrainSettings,
                                                visit_order)
from skelsplat_tpu_torch.synthetic import synthetic_inputs
from skelsplat_tpu_torch.utils import tree_leaves

N_J, A, W, H = 17, 4, 48, 40
WIDTHS = {"xyz": 3, "log_scales": 3, "quats": 4, "opacity_logit": 1}
# optimizer settings: H36M's (opacity at LR 0) and a delayed schedule
OPTS = {
    "h36m": OptConfig(),
    "delayed": OptConfig(position_lr_delay_steps=300,
                         position_lr_delay_mult=0.01),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's many small CPU ops on one torch thread: under the
    test run's parallel workers, an intra-op thread per core in every
    worker contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(opt: OptConfig, **settings) -> SceneTrainer:
    return SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0,
                                      scaling_modifier=1.0),
                        opt, TrainSettings(**settings), W, H,
                        renderer="cuda", device="cpu")


def _params(lead: tuple, rng) -> GaussianParams:
    return GaussianParams(*(
        torch.from_numpy(rng.normal(0.0, 1.0, lead + (N_J, w))
                         .astype(np.float32)) for w in WIDTHS.values()))


def _view_grads(lead: tuple, rng):
    """(losses (…,A), grads (…,A,N,·)) of one macro step: gradients over
    five decades, with zeros in the opacity group (an infinite logit's)."""
    losses = torch.from_numpy(rng.uniform(0.1, 2.0, lead + (A,))
                              .astype(np.float32))
    grads = []
    for f, w in WIDTHS.items():
        g = (rng.normal(0.0, 1.0, lead + (A, N_J, w))
             * 10.0 ** rng.uniform(-4, 1, lead + (A, N_J, w)))
        if f == "opacity_logit":
            g[..., ::3, :] = 0.0
        grads.append(torch.from_numpy(g.astype(np.float32)))
    return losses, GaussianParams(*grads)


def _step_before_kernel_c(tr: SceneTrainer, st, losses_v, grads_v, gt,
                          extent, lean: bool):
    """The macro step as written before kernel C: ``compose_macro`` with
    the visit-order gather, then the carry and history copies."""
    k = st.step
    at = k.reshape(1)
    axis = st.stop_max.dim()
    idx_all = visit_order(tr.n_macro, A, A, "cpu")
    carry, rec = ttrainer.compose_macro(
        tr.adam, A, False, False, st.carry, k, losses_v, grads_v,
        idx_all.index_select(0, at).reshape(-1), gt, extent, "mean",
        lean=lean)
    for dst, src in zip(tree_leaves(st.carry), tree_leaves(carry),
                        strict=True):
        dst.copy_(src)
    if lean:
        st.losses.select(axis, 0).copy_(rec[0])
    else:
        st.losses.index_copy_(axis, at, rec[0].unsqueeze(axis))
        st.error.index_copy_(axis, at, rec[1].unsqueeze(axis))
        st.error_rel.index_copy_(axis, at, rec[2].unsqueeze(axis))
    st.stop_max.copy_(torch.maximum(st.stop_max, rec[-1]))
    st.step.add_(1)


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


# (optimizer settings, scene axes, lean): one scene with the lean history
# the cells keep, and a batch of 3 with the full history and a delayed
# schedule; both hold a group at LR 0 (opacity)
CPU_CASES = {
    "h36m_scene_lean": ("h36m", (), True),
    "delayed_batch_full": ("delayed", (3,), False),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_cpu_path_is_the_torch_composite(case):
    """``compose_adam_step`` on CPU tensors, over all 125 macro steps of a
    500-iteration scene (or a batch of 3), leaves the loop state bitwise
    where the step before kernel C leaves it, after every step."""
    opt, lead, lean = CPU_CASES[case]
    tr = _trainer(OPTS[opt])
    assert tr.n_macro == 125
    rng = np.random.default_rng(7)
    params = _params(lead, rng)
    gt = torch.from_numpy(rng.normal(0.0, 1.0, lead + (N_J, 3))
                          .astype(np.float32))
    extent = torch.from_numpy(rng.uniform(500.0, 5000.0, lead)
                              .astype(np.float32))
    st_c = tr._loop_state(params, A, None, lean)
    st_t = tr._loop_state(params, A, None, lean)
    for _ in range(tr.n_macro):
        losses_v, grads_v = _view_grads(lead, rng)
        ttrainer.compose_adam_step(tr.adam, st_c, losses_v, grads_v, gt,
                                   extent, lean)
        _step_before_kernel_c(tr, st_t, losses_v, grads_v, gt, extent, lean)
        _assert_same(st_c, st_t)
    assert int(st_c.step) == tr.n_macro
    assert bool((st_c.carry[1].t == tr.n_macro).all())
    assert bool(torch.isfinite(st_c.carry[0].xyz).all())
    # the groups at LR 0 stay put while their moments move
    lrs = tr.adam.group_lrs(torch.tensor(A))
    for f in PARAM_FIELDS[1:]:
        if getattr(lrs, f) == 0.0:
            assert torch.equal(getattr(st_c.carry[0], f), getattr(params, f))
            assert bool((getattr(st_c.carry[1].v, f) > 0).any())


# (early_stopping, accumulation steps with 4 views, view fusion) and
# whether kernel C takes the macro step
ROUTES = {
    "no_stop_all_views_mean": ("no_stopping", 4, "mean", True),
    "no_stop_all_views_weighted": ("no_stopping", 4, "confidence_weighted",
                                   False),
    "no_stop_two_views_mean": ("no_stopping", 2, "mean", False),
    "no_stop_two_views_weighted": ("no_stopping", 2, "confidence_weighted",
                                   False),
    "stop_all_views_mean": ("opt_early_stopping", 4, "mean", False),
    "stop_all_views_weighted": ("opt_early_stopping", 4,
                                "confidence_weighted", False),
    "stop_two_views_mean": ("opt_early_stopping", 2, "mean", False),
    "stop_two_views_weighted": ("opt_early_stopping", 2,
                                "confidence_weighted", False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routing_takes_kernel_c_for_its_three_settings(route, monkeypatch):
    """Kernel C's step serves a scene exactly when it runs without early
    stopping, visits every view each macro step and fuses xyz by the
    mean; every other setting runs ``compose_macro`` and the history
    copies, step by step."""
    stopping, acc, fusion, kernel = ROUTES[route]
    settings = dict(early_stopping=stopping, accumulation_steps=acc,
                    view_fusion=fusion)
    assert ttrainer.adam_kernel_serves(TrainSettings(**settings), 4) \
        is kernel
    calls = {"kernel_c": 0, "compose_macro": 0}
    compose_adam_step, compose_macro = (ttrainer.compose_adam_step,
                                        ttrainer.compose_macro)

    def kernel_c(*args, **kwargs):
        calls["kernel_c"] += 1
        return compose_adam_step(*args, **kwargs)

    def torch_ops(*args, **kwargs):
        calls["compose_macro"] += 1
        return compose_macro(*args, **kwargs)

    monkeypatch.setattr(ttrainer, "compose_adam_step", kernel_c)
    monkeypatch.setattr(ttrainer, "compose_macro", torch_ops)
    tr = _trainer(OptConfig(iterations=16), **settings)
    init, gt, p2d, cams_np = synthetic_inputs(1, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    params, history = tr.optimize_scene(init[0], p2d[0], cams, gt[0])
    steps = tr.n_macro
    # on CPU tensors kernel C's step runs its plain version, the composite
    assert calls == {"kernel_c": steps if kernel else 0,
                     "compose_macro": steps}
    assert bool(torch.isfinite(params.xyz).all())
    assert history.losses.shape == (steps, acc)


def test_adam_moments_are_buffers_of_their_own():
    """``AdamGroups.init`` gives m and v their own zeros, so a step that
    writes one in place leaves the other alone."""
    rng = np.random.default_rng(0)
    params = _params((2,), rng)
    state = AdamGroups(OptConfig()).init(params)
    ptrs = set()
    for tree in (state.m, state.v):
        for f in PARAM_FIELDS:
            x = getattr(tree, f)
            assert x.shape == getattr(params, f).shape
            assert not bool(x.any())
            ptrs.add(x.untyped_storage().data_ptr())
    ptrs.add(params.xyz.untyped_storage().data_ptr())
    assert len(ptrs) == 2 * len(PARAM_FIELDS) + 1
    state.m.xyz.add_(1.0)
    assert not bool(state.v.xyz.any())

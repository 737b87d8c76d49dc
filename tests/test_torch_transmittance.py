"""The rasterizer's exclusive transmittance, whose backward makes no host
sync (``ops/rasterizer.py::exclusive_transmittance``): its forward against
``torch.cumprod``, bitwise, its gradient against ``torch.cumprod``'s
autograd with and without exact zeros, and the fused and dense view
losses' gradients through it against the JAX package on a crowded scene,
where transmittance runs down to the stop rule's threshold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skelsplat_tpu.engine.trainer as jtrainer
import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu.ops import fused as jfused
from skelsplat_tpu.ops import heatmaps as jhm
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core import geometry as tg
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.ops import fused as tfused
from skelsplat_tpu_torch.ops import rasterizer as trast
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J = 17
W, H = 48, 40
NV = 2
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops on one torch thread: under the test run's
    parallel workers, an intra-op thread per core in every worker contends
    for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cumprod_exclusive(x, dim):
    """The former form: a shifted inclusive ``torch.cumprod``."""
    shifted = torch.cat([torch.ones_like(x.narrow(dim, 0, 1)),
                         x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)
    return torch.cumprod(shifted, dim=dim)


def _factors(shape, dim, zeros: bool, dtype, seed=0):
    """1 − α-like factors in [0.01, 1], or with exact zeros: a whole slot,
    single entries, the first and last slot, and two zeros in one
    column."""
    g = torch.Generator().manual_seed(seed)
    x = 0.01 + 0.99 * torch.rand(shape, generator=g, dtype=dtype)
    if zeros:
        x = x.movedim(dim, 0).contiguous()
        x[3] = 0
        x[0].view(-1)[::5] = 0
        x[-1].view(-1)[::3] = 0
        x[7].view(-1)[::2] = 0
        x[11].view(-1)[::2] = 0
        x = x.movedim(0, dim).contiguous()
    return x


CASES = {"views_slots_rows_cols": ((3, 17, 5, 7), 1),
         "slots_first": ((19, 6, 4), 0),
         "scenes_views_slots_rows_cols": ((2, 2, 15, 3, 5), 2)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("zeros", [False, True])
def test_forward_is_cumprod_bitwise(case, zeros):
    shape, dim = CASES[case]
    x = _factors(shape, dim, zeros, torch.float32)
    got = trast.exclusive_transmittance(x, dim)
    assert torch.equal(got, _cumprod_exclusive(x, dim))
    if zeros:
        assert bool((got == 0).any())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradient_matches_cumprod_autograd(case, zeros, dtype):
    """Against torch.cumprod's own backward (division-free where the input
    holds a zero): float64 within 1e-12 of the gradient's scale, float32
    within 1e-6 (the two sum the same products in other orders)."""
    shape, dim = CASES[case]
    x = _factors(shape, dim, zeros, dtype)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1),
                    dtype=dtype)
    grads = []
    for fn in (trast.exclusive_transmittance, _cumprod_exclusive):
        xi = x.clone().requires_grad_(True)
        torch.autograd.backward(fn(xi, dim), g)
        grads.append(xi.grad)
    got, want = grads
    scale = want.abs().max()
    assert scale > 0
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert float((got - want).abs().max()) <= tol * float(scale)
    # the last slot never enters a transmittance
    assert bool((got.select(dim, shape[dim] - 1) == 0).all())


def test_gradient_is_exact_where_every_other_factor_is_one():
    """With x_k = 1 for k ≠ j, dT_i/dx_j = 1 for every i > j, so dL/dx_j is
    exactly Σ_{i>j} g_i, zeros and all."""
    x = torch.ones(6, 4, dtype=torch.float64)
    x[2] = torch.tensor([0.0, 0.5, 1.0, 0.25], dtype=torch.float64)
    x.requires_grad_(True)
    g = torch.arange(24, dtype=torch.float64).reshape(6, 4)
    torch.autograd.backward(trast.exclusive_transmittance(x, 0), g)
    assert torch.equal(x.grad[2], g[3:].sum(0))


@pytest.fixture(scope="module")
def crowded():
    """Joints ~80 mm apart with 3× the scale: the splats overlap, so a
    pixel's transmittance runs down to T_MIN's order, where the stop rule
    acts."""
    cams, _, _ = synthetic_rig(n_views=NV, width=W, height=H)
    rng = np.random.default_rng(5)
    gt = synthetic_skeleton(N_J, rng=rng, spread=80.0)
    gt[:, 2] = 800.0 + rng.normal(0, 80.0, N_J)
    p2d = np.stack([project_np(gt, take_cam(cams, v))
                    for v in range(NV)]).astype(np.float32)
    init = gt + rng.normal(0, 20, gt.shape).astype(np.float32)
    params = jtrainer.init_params_jnp(jnp.asarray(init), "h36m", 3.0, 1.0)
    r2 = np.random.default_rng(9)
    posed = dataclasses.replace(
        params,
        log_scales=params.log_scales + 1.1 + jnp.asarray(
            r2.normal(0, 0.3, (N_J, 3)).astype(np.float32)),
        quats=params.quats + jnp.asarray(
            r2.normal(0, 0.2, (N_J, 4)).astype(np.float32)))
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    return cams, tcams, p2d, init, params, posed


def _port_params(p):
    return compat.params_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in FIELDS},
        device="cpu").map(lambda x: x.requires_grad_(True))


def _assert_grads_close(ref, got, rel):
    for f in FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).detach().numpy()
        assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-3), f


def test_crowded_scene_runs_transmittance_down(crowded):
    _, tcams, _, _, _, posed = crowded
    tp = _port_params(posed)
    pp = trast.preprocess_gaussians(tp.xyz, tp.covariance(), tp.opacity,
                                    tcams, W, H)
    ys = torch.arange(H, dtype=torch.int32)
    xs = torch.arange(W, dtype=torch.int32)
    contrib, _ = trast.composite_weights(pp, *trast.pixel_offsets(pp, ys, xs))
    # Σ α·T = 1 − T_final: past 1 − 1e-3, T_final is within 10× of T_MIN
    assert float(contrib.detach().sum(dim=1).max()) > 1 - 10 * tg.T_MIN


@pytest.mark.parametrize("loss_fn", ["l2_gaussian", "l1_gaussian"])
def test_fused_view_loss_gradients_match_jax(crowded, loss_fn):
    """The fused row-chunk loss and its gradients against JAX's at the
    renderers' bars: loss within 1e-6, gradients within 1e-5 of their
    scale."""
    cams, tcams, p2d, _, params, posed = crowded
    spec = jhm.heatmap_spec(params.xyz, params.covariance(), jnp.asarray(p2d),
                            cams, W, H)
    tspec = compat.spec_from_numpy(jax.tree.map(np.asarray, spec),
                                   device="cpu")
    tp = _port_params(posed)
    tl = tfused.fused_view_loss(tp, tcams, tspec, W, H, loss_function=loss_fn,
                                rows_per_chunk=16)
    vg = jax.jit(jax.value_and_grad(lambda p, cam, sv: jfused.fused_view_loss(
        p, cam, sv, W, H, loss_function=loss_fn)))
    for v in range(NV):
        ref, g = vg(posed, take_cam(jax.tree.map(jnp.asarray, cams), v),
                    jax.tree.map(lambda x: x[v], spec))
        assert abs(float(ref) - float(tl[v].detach())) < 1e-6, v
        grads = torch.autograd.grad(tl[v], [getattr(tp, f) for f in FIELDS],
                                    retain_graph=True)
        _assert_grads_close(g, type(tp)(*grads), 1e-5)


def test_dense_view_loss_gradients_match_jax(crowded):
    """Each view's dense trainer loss (l2_gaussian) and gradients at the
    initial parameters against JAX's: loss within rtol 1e-5, gradients
    within 1e-5 of their scale. (The soft-argmax losses' dense gradients,
    at 1e-4, are held in tests/test_torch_options.py.)"""
    cams, tcams, p2d, init, params, _ = crowded
    kw = {"accumulation_steps": NV}
    jt = jtrainer.SceneTrainer(JModel("h36m", N_J, scaling=3.0), JOpt(),
                               jtrainer.TrainSettings(**kw), W, H,
                               renderer="dense")
    tt = ttrainer.SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                               OptConfig(), ttrainer.TrainSettings(**kw), W,
                               H, renderer="dense", device="cpu")
    spec = jhm.heatmap_spec(params.xyz, params.covariance(), jnp.asarray(p2d),
                            cams, W, H)
    per_view = jax.jit(jax.vmap(jax.value_and_grad(jt._view_loss_dense),
                                in_axes=(None, 0, 0, 0)))
    ref_loss, ref_grad = per_view(params, jax.tree.map(jnp.asarray, cams),
                                  jhm.eval_heatmaps(spec, W, H),
                                  jnp.asarray(p2d))
    tp, aux = tt._prepare(init, torch.tensor(p2d), tcams,
                          torch.zeros(NV, N_J, dtype=torch.bool))
    losses, grads = tt._per_view_grads(tp, tcams, aux, torch.tensor(p2d), NV)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_loss),
                               rtol=1e-5)
    for v in range(NV):
        _assert_grads_close(jax.tree.map(lambda x: x[v], ref_grad),
                            grads.map(lambda x: x[v]), 1e-5)

"""The port's trainer options against the JAX package: ``renderer="auto"``
(the kernel for the masked heatmap losses, dense for the others), a dense
soft-argmax loss with each view's true extent as its ``domain``,
``view_fusion="confidence_weighted"`` in every composition branch, serial
and batched, and debug mode's finite check. 12-iteration runs on the
trainer tests' 3-view 112×96 scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skelsplat_tpu.engine.trainer as jtrainer
import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu import losses as jlosses
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu.ops import heatmaps as jhm
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core.cameras import stack_cameras
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.engine.optim import OptConfig
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J = 17
W, H = 112, 96
NV = 3
ITERS = 12
SOFTARGMAX_LOSS = "l1_masked_huber"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's many small CPU ops on one torch thread: under the
    test run's parallel workers, an intra-op thread per core in every
    worker contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    cams, _, _ = synthetic_rig(n_views=NV, width=W, height=H)
    rng = np.random.default_rng(3)
    gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
    p2d = np.stack([project_np(gt, take_cam(cams, v))
                    for v in range(NV)]).astype(np.float32)
    init = gt + rng.normal(0, 50, gt.shape).astype(np.float32)
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    return cams, tcams, gt, p2d, init


def _jax(kw, renderer="auto", iterations=ITERS):
    return jtrainer.SceneTrainer(JModel("h36m", N_J, scaling=3.0),
                                 JOpt(iterations=iterations),
                                 jtrainer.TrainSettings(**kw), W, H,
                                 renderer=renderer)


def _port(kw, renderer="auto", iterations=ITERS, debug=False):
    return ttrainer.SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                                 OptConfig(iterations=iterations),
                                 ttrainer.TrainSettings(**kw), W, H,
                                 renderer=renderer, device="cpu",
                                 debug=debug)


@pytest.mark.parametrize("loss", list(jlosses.losses))
def test_auto_picks_the_jax_rules_renderer(loss):
    """JAX's rule on a host without a TPU picks "fused" for the losses its
    kernels implement and "dense" for the rest; the port's kernel takes
    the place of both fused paths."""
    kw = {"loss_function": loss}
    want = {"fused": "cuda", "dense": "dense"}[_jax(kw).renderer]
    assert _port(kw).renderer == want
    if want == "dense":
        for r in ("cuda", "fused"):
            with pytest.raises(ValueError, match="does not implement"):
                _port(kw, renderer=r)


def test_unknown_view_fusion_raises():
    with pytest.raises(ValueError, match="view_fusion"):
        _port({"view_fusion": "median"})
    with pytest.raises(ValueError, match="view_fusion"):
        ttrainer.view_fusion_fn("median")


def test_dense_softargmax_view_loss_matches_jax(scene):
    """Each view's dense loss and xyz gradient at the initial parameters
    against JAX's dense view loss run op by op (under jit, XLA contracts
    a·b+c inside exp and moves JAX's own gradients by 4e-4 of their scale
    here). The renders differ by 1 ulp at ~0.02% of the pixels, as exp
    rounds differently in each package; the soft-argmax's β = 100 scales
    that into the loss's gradient, so the bar is 100× the heatmap losses'
    1e-6: 1e-4 of the view's largest |component| (measured 4.1e-5)."""
    cams, tcams, gt, p2d, init = scene
    kw = {"accumulation_steps": NV, "loss_function": SOFTARGMAX_LOSS}
    jt, tt = _jax(kw), _port(kw)
    assert jt.renderer == tt.renderer == "dense"
    params = jtrainer.init_params_jnp(init, "h36m", 3.0, 1.0)
    spec = jhm.heatmap_spec(params.xyz, params.covariance(),
                            jnp.asarray(p2d), cams, W, H)
    gth = jhm.eval_heatmaps(spec, W, H)

    per_view = jax.vmap(jax.value_and_grad(jt._view_loss_dense),
                        in_axes=(None, 0, 0, 0))
    with jax.disable_jit():
        ref_loss, ref_grad = per_view(params, jax.tree.map(jnp.asarray, cams),
                                      gth, jnp.asarray(p2d))
    tp, aux = tt._prepare(init, torch.tensor(p2d), tcams,
                          torch.zeros(NV, N_J, dtype=torch.bool))
    losses, grads = tt._per_view_grads(tp, tcams, aux, torch.tensor(p2d), NV)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_loss),
                               rtol=1e-5)
    for v in range(NV):
        jg = np.asarray(ref_grad.xyz[v])
        assert np.abs(grads.xyz[v].numpy() - jg).max() <= \
            1e-4 * np.abs(jg).max(), v


def test_dense_softargmax_run_matches_jax(scene):
    """12 iterations of the dense soft-argmax path against JAX's trainer.
    The first macro step (3 iterations) stays within the trainer bar of
    1e-4 mm. Afterwards the gradient's ~4e-5 relative differences
    (test_dense_softargmax_view_loss_matches_jax) meet Adam's normalized
    step where a joint's gradient nearly cancels over the views: after 12
    iterations xyz differ by 1.64e-3 mm here, and JAX's own jit and op-by-op
    forms differ by 4.0e-4 mm on this scene and by up to 4.5e-3 mm over
    seeds 3-7 of it, so xyz are held at 5e-3 mm; the losses at rtol 1e-5 and
    the MPJPE within 1e-3 mm."""
    cams, tcams, gt, p2d, init = scene
    kw = {"accumulation_steps": NV, "loss_function": SOFTARGMAX_LOSS}
    for iters, atol in ((NV, 1e-4), (ITERS, 5e-3)):
        jp, jh = _jax(kw, iterations=iters).optimize_scene(init, p2d, cams, gt)
        tp, th = _port(kw, iterations=iters).optimize_scene(init, p2d, tcams,
                                                            gt)
        np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(th.losses.numpy(), np.asarray(jh.losses),
                                   rtol=1e-5)
    m_t = np.linalg.norm(tp.xyz.numpy() - gt, axis=1).mean()
    m_j = np.linalg.norm(np.asarray(jp.xyz) - gt, axis=1).mean()
    assert abs(m_t - m_j) < 1e-3
    assert float(th.error[-1].mean()) < float(th.error[0].mean())


@pytest.mark.parametrize("case", ["accum_eq_views", "accum_ne_views",
                                  "early_stop"])
def test_confidence_weighted_fusion_matches_jax(scene, case, monkeypatch):
    """The kernel path (its plain version here) with
    ``view_fusion=confidence_weighted`` against JAX's fused renderer with
    the same fusion: the plain composition, the general accumulation
    window's stale rows and a mid-macro early stop (every window
    "repeats", so it fires at iteration 8)."""
    cams, tcams, gt, p2d, init = scene
    kw = {"accumulation_steps": NV, "view_fusion": "confidence_weighted"}
    if case == "accum_ne_views":
        kw["accumulation_steps"] = 4
    elif case == "early_stop":
        kw["early_stopping"] = "opt_early_stopping"
        monkeypatch.setattr(jtrainer, "REPEAT_TOL", 1e6)
        monkeypatch.setattr(ttrainer, "REPEAT_TOL", 1e6)
    jp, jh = _jax(kw, renderer="fused").optimize_scene(init, p2d, cams, gt)
    tt = _port(kw)
    assert tt.renderer == "cuda"
    tp, th = tt.optimize_scene(init, p2d, tcams, gt)
    np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(th.losses.numpy(), np.asarray(jh.losses),
                               rtol=1e-5, atol=1e-7)
    assert int(th.stopped_at) == int(jh.stopped_at) == \
        (8 if case == "early_stop" else 0)
    # the fusion is live: the plain mean steps elsewhere
    mp, _ = _port({**kw, "view_fusion": "mean"}).optimize_scene(
        init, p2d, tcams, gt)
    assert np.abs(mp.xyz.numpy() - tp.xyz.numpy()).max() > 1e-3


def test_batched_fusion_is_the_serial_fusion(scene):
    """Three scenes of one rig in one optimize_scene_batch with
    confidence-weighted fusion: each scene bitwise its optimize_scene
    run."""
    cams, tcams, gt, p2d, init = scene
    rng = np.random.default_rng(11)
    inits = np.stack([init + rng.normal(0, 20, init.shape).astype(np.float32)
                      for _ in range(3)])
    kw = {"accumulation_steps": NV, "view_fusion": "confidence_weighted"}
    tt = _port(kw)
    bp, bh = tt.optimize_scene_batch(inits, np.stack([p2d] * 3),
                                     stack_cameras([tcams] * 3),
                                     np.stack([gt] * 3))
    for b in range(3):
        sp, sh = tt.optimize_scene(inits[b], p2d, tcams, gt)
        assert torch.equal(bp.xyz[b], sp.xyz), b
        assert torch.equal(bh.losses[b], sh.losses), b


def test_debug_checks_every_step(scene):
    """Debug mode changes no number; a NaN in the initial pose raises
    FloatingPointError naming the first macro step."""
    cams, tcams, gt, p2d, init = scene
    kw = {"accumulation_steps": NV}
    p_off, h_off = _port(kw).optimize_scene(init, p2d, tcams, gt)
    p_on, h_on = _port(kw, debug=True).optimize_scene(init, p2d, tcams, gt)
    assert torch.equal(p_on.xyz, p_off.xyz)
    assert torch.equal(h_on.losses, h_off.losses)
    bad = init.copy()
    bad[4, 1] = np.nan
    with pytest.raises(FloatingPointError, match="macro step 0 "):
        _port(kw, debug=True).optimize_scene(bad, p2d, tcams, gt)
    # without debug the NaN runs through unchecked
    nan_p, _ = _port(kw).optimize_scene(bad, p2d, tcams, gt)
    assert not torch.isfinite(nan_p.xyz).all()

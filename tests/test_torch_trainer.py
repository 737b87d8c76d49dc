"""The port's SceneTrainer, Adam and early-stopping window against the JAX
package: 12 iterations of the port (renderer="cuda", its plain PyTorch
kernel version on the CPU) against JAX SceneTrainer(renderer="fused")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skelsplat_tpu.engine.trainer as jtrainer
from skelsplat_tpu.core.gaussians import GaussianParams as JParams
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import AdamGroups as JAdam
from skelsplat_tpu.engine.optim import OptConfig as JOpt
import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core.gaussians import GaussianParams, SkeletonModel
from skelsplat_tpu_torch.engine.optim import AdamGroups, OptConfig
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J = 17
W, H = 112, 96
NV = 3
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")


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


def _run_both(scene, settings_kw, renderer="cuda", iterations=12,
              drop_mask=None):
    cams, tcams, gt, p2d, init = scene
    jt = jtrainer.SceneTrainer(JModel("h36m", N_J, scaling=3.0),
                               JOpt(iterations=iterations),
                               jtrainer.TrainSettings(**settings_kw), W, H,
                               renderer="fused")
    tt = ttrainer.SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                               OptConfig(iterations=iterations),
                               ttrainer.TrainSettings(**settings_kw), W, H,
                               renderer=renderer, device="cpu")
    jp, jh = jt.optimize_scene(init, p2d, cams, gt, drop_mask=drop_mask)
    tp, th = tt.optimize_scene(init, p2d, tcams, gt, drop_mask=drop_mask)
    return (jp, jh), (tp, th)


@pytest.mark.parametrize("case", ["accum_eq_views", "accum_ne_views",
                                  "early_stop"])
def test_trainer_matches_jax(scene, case, monkeypatch):
    kw = {"accumulation_steps": 3}
    drop = None
    if case == "accum_ne_views":
        # visits (k·4 + j) mod 3: stale rows; with joint dropout
        kw = {"accumulation_steps": 4, "dropout": True}
        drop = np.zeros((NV, N_J), bool)
        drop[[0, 2], 5] = True
        drop[1, 11] = True
    elif case == "early_stop":
        kw = {"accumulation_steps": 3, "early_stopping": "opt_early_stopping"}
        # every window "repeats": the stop fires at the earliest gated
        # iteration (8), mid-way through macro step 3
        monkeypatch.setattr(jtrainer, "REPEAT_TOL", 1e6)
        monkeypatch.setattr(ttrainer, "REPEAT_TOL", 1e6)
    (jp, jh), (tp, th) = _run_both(scene, kw, drop_mask=drop)
    np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.log_scales.numpy(), np.asarray(jp.log_scales),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.losses.numpy(), np.asarray(jh.losses),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(th.error.numpy(), np.asarray(jh.error),
                               rtol=0, atol=1e-4)
    assert int(th.stopped_at) == int(jh.stopped_at)
    if case == "early_stop":
        assert int(th.stopped_at) == 8
        np.testing.assert_allclose(th.hist8.numpy(), np.asarray(jh.hist8),
                                   rtol=1e-5)
    else:
        assert int(th.stopped_at) == 0
        assert float(th.error[-1].mean()) < float(th.error[0].mean())


@pytest.mark.slow
def test_full_budget_mpjpe_matches_jax(scene):
    """500 iterations (the stock budget) of the port against JAX: MPJPE
    within the port's 0.5 mm end-check bar."""
    (jp, jh), (tp, th) = _run_both(scene, {}, iterations=500)
    gt = scene[2]
    m_j = float(np.mean(np.linalg.norm(np.asarray(jp.xyz) - gt, axis=1)))
    m_t = float(np.mean(np.linalg.norm(tp.xyz.numpy() - gt, axis=1)))
    dx = float(np.abs(tp.xyz.numpy() - np.asarray(jp.xyz)).max())
    print(f"\nMPJPE jax {m_j:.6f} mm, port {m_t:.6f} mm, "
          f"|ΔMPJPE| {abs(m_t - m_j):.6f} mm, max |Δxyz| {dx:.6f} mm")
    assert abs(m_t - m_j) < 0.5


@pytest.mark.parametrize("renderer", ["fused", "dense"])
def test_port_renderers_agree_with_kernel_path(scene, renderer):
    cams, tcams, gt, p2d, init = scene
    out = {}
    for r in ("cuda", renderer):
        tt = ttrainer.SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                                   OptConfig(iterations=6),
                                   ttrainer.TrainSettings(accumulation_steps=3),
                                   W, H, renderer=r, device="cpu")
        out[r] = tt.optimize_scene(init, p2d, tcams, gt, lean=True)
    np.testing.assert_allclose(out[renderer][0].xyz.numpy(),
                               out["cuda"][0].xyz.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[renderer][1].losses.numpy(),
                               out["cuda"][1].losses.numpy(), rtol=1e-5)
    assert out["cuda"][1].losses.shape == (1, 3)


def test_adam_groups_step_by_step():
    rng = np.random.default_rng(7)
    shapes = {"xyz": (N_J, 3), "log_scales": (N_J, 3), "quats": (N_J, 4),
              "opacity_logit": (N_J, 1)}
    p0 = {f: rng.normal(0, 100 if f == "xyz" else 1, s).astype(np.float32)
          for f, s in shapes.items()}
    cfg = dict(iterations=500)
    jadam, tadam = JAdam(JOpt(**cfg)), AdamGroups(OptConfig(**cfg))
    jp = JParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    tp = compat.params_from_numpy(p0, device="cpu")
    js, ts = jadam.init(jp), tadam.init(tp)
    extent = np.float32(4623.7)
    for step in range(6):
        g = {f: (rng.normal(0, 1e-3, s) * (0 if step == 2 else 1)
                 ).astype(np.float32) for f, s in shapes.items()}
        it = 4 * (step + 1)
        jp, js = jadam.step(jp, JParams(**{f: jnp.asarray(v) for f, v in g.items()}),
                            js, it, jnp.asarray(extent))
        tp, ts = tadam.step(tp, GaussianParams(*(torch.tensor(g[f]) for f in FIELDS)),
                            ts, torch.tensor(it), torch.tensor(extent))
        for f in FIELDS:
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert int(ts.t) == int(js.t) == step + 1
    np.testing.assert_allclose(ts.v.xyz.numpy(), np.asarray(js.v.xyz),
                               rtol=1e-5, atol=0)


def test_stop_offset_matches_jax():
    rng = np.random.default_rng(5)
    for trial in range(30):
        A = int(rng.integers(1, 7))
        hist = rng.normal(1.0, 1e-6, 8).astype(np.float32)
        if trial % 3 == 0:
            hist[: int(rng.integers(0, 8))] = np.inf
        cur = (hist[-1] + rng.normal(0, 1e-6 if trial % 2 else 1e-3, A)
               ).astype(np.float32)
        js, jm, jh = jtrainer.stop_offset(jnp.asarray(hist), jnp.asarray(cur),
                                          1, 1e-6)
        ts, tm, th = ttrainer.stop_offset(torch.tensor(hist), torch.tensor(cur),
                                          1e-6)
        assert bool(ts) == bool(js) and int(tm) == int(jm)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))

"""A scene's prepare in the port: ``init_params`` over leading scene axes,
the batch's vectorized prepare (``SceneTrainer._prepare_batch``) against
the loop of one-scene ``_prepare`` calls and against JAX's
``jax.vmap(prepare)``, and the captured scene programs' buffer logic
(group buffers, the device scene counter, the chain's collect and its
carried window) with each graph replaced by a call of its function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skelsplat_tpu.engine.trainer as jtrainer
import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core.gaussians import (EXTREMITY_JOINTS, N_JOINTS,
                                                OPACITY_INIT_LOGIT,
                                                SkeletonModel, init_params)
from skelsplat_tpu_torch.engine import graphs
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.ops import heatmaps as thm
from skelsplat_tpu_torch.utils import tree_leaves
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J, W, H, B = 17, 96, 80, 3
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")
# the renderers' view aux, each with a loss it implements
RENDERER_LOSSES = {"cuda": "l2_gaussian", "fused": "l2_gaussian",
                   "dense": "l1_masked_huber"}
# the port's spec and heatmaps against JAX's: tests/test_torch_heatmaps.py's
# bars (float fields within 2e-6 relative, int fields exact, heatmaps
# within 2e-6 absolute of their [0, 1] range)
SPEC_RTOL = 2e-6
HEATMAP_ATOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's many small CPU ops on one torch thread: under the
    test run's parallel workers, an intra-op thread per core in every
    worker contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same(a, b):
    """Every tensor of two trees bitwise equal."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _scenes(nviews: int, seed: int = 3):
    """B scenes of one (W, H, V) shape, each with its own rig: (init
    (B,N,3), gt, p2d (B,V,N,2), JAX cameras with (B, V) numpy leaves, the
    port's (B, V) Camera, a drop mask (B,V,N) that zeroes a few channels)."""
    rigs = [synthetic_rig(n_views=nviews, width=W, height=H, dist=d,
                          focal=f)[0]
            for d, f in ((3600.0, 900.0), (4000.0, 950.0), (4400.0, 1000.0))]
    rng = np.random.default_rng(seed)
    inits, gts, p2ds = [], [], []
    for cams in rigs:
        gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
        p2ds.append(np.stack([project_np(gt, take_cam(cams, v))
                              for v in range(nviews)]).astype(np.float32))
        inits.append((gt + rng.normal(0, 40, gt.shape)).astype(np.float32))
        gts.append(gt.astype(np.float32))
    jcams = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                         *rigs)
    tcams = compat.camera_from_numpy(jcams, device="cpu")
    drop = np.zeros((B, nviews, N_J), dtype=bool)
    drop[0, 1, [2, 9]] = True
    drop[2, nviews - 1, 5] = True
    return (np.stack(inits), np.stack(gts), np.stack(p2ds), jcams, tcams,
            drop)


def _port(renderer="cuda", iterations=8, **settings):
    settings.setdefault("loss_function", RENDERER_LOSSES[renderer])
    return ttrainer.SceneTrainer(
        SkeletonModel("h36m", N_J, scaling=3.0), OptConfig(iterations),
        ttrainer.TrainSettings(**settings), W, H, renderer=renderer,
        device="cpu")


@pytest.mark.parametrize("scaling,modifier", [(3.0, 1.25), (2.7, 0.9),
                                              (-1.0, 1.0)])
@pytest.mark.parametrize("scene_type", sorted(N_JOINTS))
def test_init_params_over_scene_axes_is_each_scene(scene_type, scaling,
                                                   modifier):
    """init_params over a (B,N,3) pose equals B one-scene calls bitwise,
    and each equals the numpy construction it replaced and JAX's
    init_params_jnp (numpy float32 fills and an in-place float32 multiply
    of the extremity rows)."""
    n = N_JOINTS[scene_type]
    pose = np.random.default_rng(1).normal(0, 500, (B, n, 3)).astype(
        np.float32)
    batch = init_params(torch.as_tensor(pose), scene_type, scaling,
                        modifier, device="cpu")
    from_numpy = init_params(pose, scene_type, scaling, modifier,
                             device="cpu")
    _assert_same(batch, from_numpy)
    for b in range(B):
        one = init_params(pose[b], scene_type, scaling, modifier,
                          device="cpu")
        _assert_same(batch.map(lambda x, b=b: x[b]), one)
        if scaling > 0:
            scales = np.full((n, 3), scaling, dtype=np.float32)
            scales[EXTREMITY_JOINTS[scene_type], :] *= modifier
        else:
            scales = pose[b]
        quats = np.zeros((n, 4), np.float32)
        quats[:, 0] = 1.0
        for got, want in zip(
                (one.xyz, one.log_scales, one.quats, one.opacity_logit),
                (pose[b], scales, quats,
                 np.full((n, 1), OPACITY_INIT_LOGIT, np.float32))):
            np.testing.assert_array_equal(got.numpy(), want)
        ref = jtrainer.init_params_jnp(jnp.asarray(pose[b]), scene_type,
                                       scaling, modifier)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(one, f).numpy(),
                                          np.asarray(getattr(ref, f)))
    assert init_params(pose[0].reshape(-1), scene_type, scaling, modifier,
                       device="cpu").xyz.shape == (n, 3)


@pytest.mark.parametrize("dropout", [False, True], ids=["no_drop", "drop"])
@pytest.mark.parametrize("nviews", [4, 3])
@pytest.mark.parametrize("renderer", list(RENDERER_LOSSES))
def test_prepare_batch_is_the_loop(renderer, nviews, dropout):
    """The vectorized prepare of B scenes is bitwise the loop of one-scene
    _prepare calls: parameters (B,N,·) and each scene's view aux at rows
    b·V..b·V+V-1, for the kernel's profiles, the fused renderer's spec and
    the dense renderer's heatmaps."""
    init, _, p2d, _, tcams, drop = _scenes(nviews)
    if not dropout:
        drop = np.zeros_like(drop)
    tr = _port(renderer)
    init_t, p2d_t, drop_t = map(torch.as_tensor, (init, p2d, drop))
    params_b, aux_b = tr._prepare_batch(init_t, p2d_t, tcams, drop_t)
    assert params_b.xyz.shape == (B, N_J, 3)
    for b in range(B):
        params, aux = tr._prepare(init_t[b], p2d_t[b],
                                  tcams.map(lambda x, b=b: x[b]), drop_t[b])
        rows = slice(b * nviews, (b + 1) * nviews)
        _assert_same(params_b.map(lambda x, b=b: x[b]), params)
        if isinstance(aux, torch.Tensor):
            _assert_same(aux_b[rows], aux)
        else:
            _assert_same(aux_b.take(rows), aux)


@pytest.mark.parametrize("renderer", ["fused", "dense"])
def test_prepare_batch_matches_jax_vmap(renderer):
    """The port's batch prepare against JAX's jitted jax.vmap(prepare) on
    the same inputs (3 scenes, 3 views, a drop mask): parameters and the
    fresh carry exact, the spec (fused) and heatmaps (dense) within
    tests/test_torch_heatmaps.py's bars."""
    init, _, p2d, jcams, tcams, drop = _scenes(3)
    jt = jtrainer.SceneTrainer(JModel("h36m", N_J, scaling=3.0), JOpt(8),
                               jtrainer.TrainSettings(
                                   loss_function=RENDERER_LOSSES[renderer]),
                               W, H, renderer=renderer)
    carry, jaux = jt._prepare_b(jnp.asarray(init), jnp.asarray(p2d), jcams,
                                jnp.asarray(drop))
    tr = _port(renderer)
    params, aux = tr._prepare_batch(*map(torch.as_tensor, (init, p2d)),
                                    tcams, torch.as_tensor(drop))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(carry[0], f)))
    if renderer == "dense":
        assert aux.shape == (B * 3, N_J, H, W)
        np.testing.assert_allclose(aux.numpy(),
                                   np.asarray(jaux).reshape(aux.shape),
                                   rtol=0, atol=HEATMAP_ATOL)
        return
    for f in thm.HeatmapSpec._fields:
        port = getattr(aux, f).numpy()
        ref = np.asarray(getattr(jaux, f)).reshape(port.shape)
        if port.dtype == np.int32:
            np.testing.assert_array_equal(port, ref, err_msg=f)
        else:
            np.testing.assert_allclose(port, ref, rtol=SPEC_RTOL, atol=0,
                                       err_msg=f)
    assert (aux.amp.numpy().reshape(B, 3, N_J)[drop] == 0).all()


class _Called:
    """A captured program's stand-in on the CPU: every call runs the
    function, as a replay reruns its kernels on the same buffers."""

    def __init__(self, fn, warmup, kind):
        self._fn = fn
        self.graph = None
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return self._fn()


def test_captured_programs_match_eager_on_the_cpu(monkeypatch):
    """The captured path's buffer logic, each graph replaced by a call of
    its function: chains of 2 and then 3 scenes (the group buffers grow),
    early stopping that fires with the window carried between scenes and
    calls, general accumulation (A = 3, V = 4), then one scene and a batch
    of 2, bitwise the eager trainer's results."""
    monkeypatch.setattr(graphs, "Program", _Called)
    monkeypatch.setattr(ttrainer, "REPEAT_TOL", 1e6)
    init, gt, p2d, _, tcams, _ = _scenes(4)
    cams = [tcams.map(lambda x, b=b: x[b]) for b in range(B)]
    kw = {"early_stopping": "opt_early_stopping", "accumulation_steps": 3}
    eager, captured = _port(**kw), _port(**kw)
    monkeypatch.setattr(ttrainer.SceneTrainer, "captures",
                        property(lambda self: self is captured))
    hins = [eager.host_inputs(init[b], p2d[b], cams[b], gt[b])
            for b in range(B)]
    h8 = {}
    for tr in (eager, captured):
        first = tr.optimize_scene_chain(hins[:2])
        second = tr.optimize_scene_chain(hins, hist8_init=first[1].hist8)
        one = tr.optimize_scene(init[0], p2d[0], cams[0], gt[0],
                                hist8_init=second[1].hist8)
        batch = tr.optimize_scene_batch(init[:2], p2d[:2],
                                        tcams.map(lambda x: x[:2]), gt[:2])
        h8[tr is captured] = (first, second, one, batch)
    for got, want in zip(h8[True], h8[False]):
        _assert_same(got, want)
    # 8 iterations are 2 macro steps of 3: scene 0 ends with 6 losses in
    # its window, and scene 1 stops at its 2nd iteration, from that window
    assert h8[True][0][1].stopped_at.tolist() == [0, 2]
    (chain_graph, batch_graph) = captured.graphs.values()
    assert chain_graph.capacity == 3 and batch_graph.capacity == 1
    # the chain of 3 grew the group buffers, and with them came a new
    # prepare program: its 3 scenes and the one scene after it
    assert chain_graph.prepare_program.calls == 3 + 1
    assert chain_graph.step_program.calls == 6 * captured.n_macro

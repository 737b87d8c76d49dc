"""Scene chaining and the one-program-per-scene loop of the port, against
the JAX package and against the port's own serial loop:
``SceneTrainer.optimize_scene_chain`` against JAX's (both stopping modes,
full and lean telemetry), the chain bitwise the serial loop with the
early-stop window carried, ``optimize_scene(inputs=...)`` bitwise the
direct call, the device-step macro loop bitwise an eager loop that indexes
each step from Python, and the CLI's grouped, chained sweep bitwise its
``pipeline_scenes=false`` sweep."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import skelsplat_tpu.engine.trainer as jtrainer
import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch import train as ttrain_cli
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.tools import make_synthetic_dataset
from skelsplat_tpu_torch.utils import put_trees
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J, W, H, NV = 17, 112, 96, 3
ITERS = 16
G = 3
# xyz bar against JAX, in mm: the batch tests' (test_torch_batch.XYZ_ATOL),
# for the same reason. A coordinate whose gradient nearly cancels over the
# views carries the packages' ~1e-6 relative rounding difference into
# Adam's normalized step; on these scenes each package's serial
# optimize_scene already parts from the other's by 1.1e-4 to 4.0e-4 mm
# within 12-16 iterations (10-17 ulps), and the chain adds nothing to it:
# it is bitwise the port's serial loop (test_chain_is_the_serial_loop).
XYZ_ATOL = 1e-3
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")


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
    """One rig and G initial poses spread around one GT pose."""
    cams, _, _ = synthetic_rig(n_views=NV, width=W, height=H)
    rng = np.random.default_rng(9)
    gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
    p2d = np.stack([project_np(gt, take_cam(cams, v))
                    for v in range(NV)]).astype(np.float32)
    inits = [(gt + rng.normal(0, 40, gt.shape)).astype(np.float32)
             for _ in range(G)]
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    return cams, tcams, gt, p2d, inits


def _port(stopping, iterations=ITERS, **kw):
    return ttrainer.SceneTrainer(
        SkeletonModel("h36m", N_J, scaling=3.0),
        OptConfig(iterations=iterations),
        ttrainer.TrainSettings(early_stopping=stopping, **kw), W, H,
        renderer="cuda", device="cpu")


def _stop_fires(monkeypatch):
    """Every window "repeats": the first scene stops at iteration 8, and a
    scene that starts from its predecessor's full window at iteration 1."""
    monkeypatch.setattr(jtrainer, "REPEAT_TOL", 1e6)
    monkeypatch.setattr(ttrainer, "REPEAT_TOL", 1e6)


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
@pytest.mark.parametrize("stopping", ["no_stopping", "opt_early_stopping"])
def test_chain_matches_jax_chain(scene, stopping, lean, monkeypatch):
    cams, tcams, gt, p2d, inits = scene
    if stopping == "opt_early_stopping":
        _stop_fires(monkeypatch)
    jt = jtrainer.SceneTrainer(JModel("h36m", N_J, scaling=3.0),
                               JOpt(iterations=ITERS),
                               jtrainer.TrainSettings(early_stopping=stopping),
                               W, H, renderer="fused")
    tt = _port(stopping)
    jp, jh = jt.optimize_scene_chain(
        [jt.host_inputs(i, p2d, cams, gt) for i in inits], lean=lean)
    tp, th = tt.optimize_scene_chain(
        [tt.host_inputs(i, p2d, tcams, gt) for i in inits], lean=lean)
    rows = 1 if lean else ITERS // 4
    assert th.losses.shape == (G, rows, 4) == tuple(jh.losses.shape)
    assert th.error.shape == (G, rows, N_J) and th.stopped_at.shape == (G,)
    np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz), rtol=0,
                               atol=XYZ_ATOL)
    np.testing.assert_allclose(tp.log_scales.numpy(),
                               np.asarray(jp.log_scales), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.losses.numpy(), np.asarray(jh.losses),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(th.error.numpy(), np.asarray(jh.error),
                               rtol=0, atol=XYZ_ATOL)
    np.testing.assert_array_equal(th.stopped_at.numpy(),
                                  np.asarray(jh.stopped_at))
    if stopping == "opt_early_stopping":
        assert th.stopped_at.tolist() == [8, 1, 1]
        np.testing.assert_allclose(th.hist8.numpy(), np.asarray(jh.hist8),
                                   rtol=1e-5)
    else:
        assert th.hist8 is None and jh.hist8 is None
        assert th.stopped_at.tolist() == [0] * G


@pytest.mark.parametrize("stopping", ["no_stopping", "opt_early_stopping"])
def test_chain_is_the_serial_loop(scene, stopping, monkeypatch):
    """JAX's contract (tests/test_engine.py::test_chained_scenes_match_serial)
    on the port: the chain is bitwise ``optimize_scene`` in a loop with the
    window carried from scene to scene, its lean variant bitwise the full
    one's last row, and a seeded window passes through."""
    _, tcams, gt, p2d, inits = scene
    if stopping == "opt_early_stopping":
        _stop_fires(monkeypatch)
    tt = _port(stopping, accumulation_steps=3)
    seed = torch.linspace(2.0, 3.0, 8)
    h8, serial = seed, []
    for i in inits:
        ps, hs = tt.optimize_scene(i, p2d, tcams, gt, hist8_init=h8)
        if hs.hist8 is not None:
            h8 = hs.hist8
        serial.append((ps, hs))
    hins = [tt.host_inputs(i, p2d, tcams, gt) for i in inits]
    pg, hg = tt.optimize_scene_chain(hins, hist8_init=seed)
    for s, (ps, hs) in enumerate(serial):
        for f in FIELDS:
            assert torch.equal(getattr(pg, f)[s], getattr(ps, f)), (s, f)
        for f in ("losses", "error", "error_rel", "stopped_at"):
            assert torch.equal(getattr(hg, f)[s], getattr(hs, f)), (s, f)
    if stopping == "opt_early_stopping":
        assert torch.equal(hg.hist8, h8)
        assert hg.stopped_at.tolist() == [1, 1, 1]
    else:
        assert hg.hist8 is None
    pl, hl = tt.optimize_scene_chain(hins, hist8_init=seed, lean=True)
    assert torch.equal(pl.xyz, pg.xyz)
    for f in ("losses", "error", "error_rel"):
        assert getattr(hl, f).shape[1] == 1
        assert torch.equal(getattr(hl, f)[:, 0], getattr(hg, f)[:, -1])
    assert torch.equal(hl.stopped_at, hg.stopped_at)
    if stopping == "opt_early_stopping":
        assert torch.equal(hl.hist8, hg.hist8)


def test_optimize_scene_inputs_is_the_direct_call(scene):
    """One packed copy of two scenes' host inputs, each handed back via
    ``inputs=``, gives the direct call's results bitwise; every leaf of
    the copy starts at a fresh allocation's alignment."""
    _, tcams, gt, p2d, inits = scene
    tt = _port("no_stopping", dropout=True)
    drop = np.zeros((NV, N_J), bool)
    drop[1, 4] = True
    hins = [tt.host_inputs(i, p2d, tcams, gt, drop_mask=drop)
            for i in inits[:2]]
    assert [type(x).__name__ for x in hins[0]] == [
        "ndarray", "ndarray", "Camera", "ndarray", "ndarray", "ndarray"]
    group = put_trees(hins, "cpu")
    for inputs in group:    # the packed leaves (the CPU cameras stay put)
        for k in (0, 1, 3, 4, 5):
            assert inputs[k].data_ptr() % 512 == 0
    for i, inputs in zip(inits, group):
        pi, hi = tt.optimize_scene(None, None, inputs=inputs)
        pd, hd = tt.optimize_scene(i, p2d, tcams, gt, drop_mask=drop)
        for f in FIELDS:
            assert torch.equal(getattr(pi, f), getattr(pd, f)), f
        assert torch.equal(hi.losses, hd.losses)
        assert torch.equal(hi.error, hd.error)


def _reference_run(tt, init, p2d, tcams, gt, ckpt_its, ckpt_fn):
    """The macro loop as an eager loop that indexes each step from Python
    (macro step k's visits, its iteration and its history rows): the form
    of ``SceneTrainer._run`` before the step index moved to the device."""
    init_np, p2d_np, _, gt_np, drop_np, extent = tt.host_inputs(
        init, p2d, tcams, gt)
    params, view_aux = tt._prepare(init_np, torch.as_tensor(p2d_np), tcams,
                                   torch.as_tensor(drop_np))
    poses_2d = torch.as_tensor(p2d_np)
    pose_3d_gt = torch.as_tensor(gt_np)
    extent = torch.full((), float(extent), dtype=torch.float32)
    A, K, nviews = tt.settings.accumulation_steps, tt.n_macro, NV
    general = A != nviews
    use_stop = tt.settings.early_stopping == "opt_early_stopping"
    carry = ttrainer.init_macro_carry(params, tt.adam.init(params), nviews,
                                      use_stop, general)
    ks = torch.arange(K, dtype=torch.int64)
    idx_all = ttrainer.visit_order(K, A, nviews, "cpu")
    losses_h = torch.zeros((K, A))
    err_h = torch.zeros((K, N_J))
    stop_max = torch.zeros((), dtype=torch.int64)
    saves = {min(max(it // A, 0), K) for it in ckpt_its} - {0}
    for k in range(K):
        flat = idx_all[k]
        losses_v, grads_v = tt._per_view_grads(
            carry[0], tcams.take(flat), view_aux.take(flat), poses_2d[flat],
            A)
        carry, rec = ttrainer.compose_macro(
            tt.adam, A, use_stop, general, carry, ks[k], losses_v, grads_v,
            idx_all[k], pose_3d_gt, extent)
        losses_h[k, :] = rec[0]
        err_h[k, :] = rec[1]
        stop_max = torch.maximum(stop_max, rec[-1])
        if k + 1 in saves:
            ckpt_fn((k + 1) * A, carry[0])
    return carry[0], losses_h, err_h, stop_max


@pytest.mark.parametrize("case", ["a_eq_v", "a_ne_v_checkpoint",
                                  "a_ne_v_stop"])
def test_device_step_loop_matches_python_indexed_loop(scene, case,
                                                      monkeypatch):
    """12 iterations of ``optimize_scene`` (the step index a device
    counter, every state tensor written in place) bitwise the eager loop
    that indexes macro step k from Python, checkpoints included."""
    _, tcams, gt, p2d, inits = scene
    kw = {"accumulation_steps": 3 if case == "a_eq_v" else 4}
    stopping = "no_stopping"
    if case == "a_ne_v_stop":
        _stop_fires(monkeypatch)
        stopping = "opt_early_stopping"
    tt = _port(stopping, iterations=12, **kw)
    ckpt = [4, 8] if case == "a_ne_v_checkpoint" else []
    saves = {"ref": [], "port": []}
    ref = _reference_run(tt, inits[0], p2d, tcams, gt, ckpt,
                         lambda it, p: saves["ref"].append((it, p)))
    params, hist = tt.optimize_scene(
        inits[0], p2d, tcams, gt, checkpoint_iterations=ckpt,
        checkpoint_fn=lambda it, p: saves["port"].append((it, p)))
    for f in FIELDS:
        assert torch.equal(getattr(params, f), getattr(ref[0], f)), f
    assert torch.equal(hist.losses, ref[1])
    assert torch.equal(hist.error, ref[2])
    assert torch.equal(hist.stopped_at, ref[3])
    assert [it for it, _ in saves["port"]] == [it for it, _ in saves["ref"]]
    assert [it for it, _ in saves["port"]] == ([4, 8] if ckpt else [])
    for (_, p), (_, r) in zip(saves["port"], saves["ref"]):
        assert all(torch.equal(getattr(p, f), getattr(r, f)) for f in FIELDS)
    if case == "a_ne_v_stop":
        assert int(hist.stopped_at) == 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 4-scene H36M tree whose first initial-guess file lies 1e7 mm off
    every frustum: its scenes render nothing, so their loss repeats and
    the early stop fires, and the window they leave carries on."""
    root = tmp_path_factory.mktemp("data") / "synth-h36m"
    assert make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 64, 64,
                                             image_size=96) == 4
    path = sorted(root.glob("initial_guess/**/poses.npz"))[0]
    poses = np.load(path)["poses"]
    poses[..., 2] += 1e7
    np.savez(path, poses=poses)
    return str(root)


def test_grouped_cli_sweep_matches_serial_sweep(tree, tmp_path):
    """The CLI in groups of 3 (a chain of 3, then one scene) against
    ``pipeline_scenes=false``, with early stopping and one save at the
    last iteration: summary rows and PLYs bitwise (JAX's
    tests/test_integration.py::test_chained_sweep_matches_serial)."""
    runs = {}
    for tag, knob in (("grouped", "+training.fetch_scenes=3"),
                      ("serial", "+training.pipeline_scenes=false")):
        run = tmp_path / tag
        ttrain_cli.main([
            "--config-name", "h36m.yaml", "--device", "cpu",
            f"dataset.data_root={tree}", "dataset.end_scene_id=4",
            "optimization.iterations=24", "debug.save_iterations=[24]",
            "debug.save_images=false", "training.consistency_loss=none",
            "training.early_stopping=opt_early_stopping", knob,
            f"hydra.run.dir={run}"])
        runs[tag] = (run, json.load(open(run / "train_summary.json")))
    (grun, grouped), (srun, serial) = runs["grouped"], runs["serial"]
    assert grouped["pipelined_scenes"] and not serial["pipelined_scenes"]
    assert len(grouped["scenes"]) == len(serial["scenes"]) == 4
    stops = [s["stopped_at"] for s in serial["scenes"]]
    assert any(stops) and not all(stops), stops
    for g, s in zip(grouped["scenes"], serial["scenes"]):
        assert {k: v for k, v in g.items() if k != "seconds"} == \
            {k: v for k, v in s.items() if k != "seconds"}
        rel = os.path.join("point_cloud",
                           f"iteration_{s['stopped_at'] or 24}",
                           f"{s['scene_name']}.ply")
        with open(grun / rel, "rb") as f1, open(srun / rel, "rb") as f2:
            assert f1.read() == f2.read(), rel
    for run in (grun, srun):
        assert sorted(os.listdir(run / "point_cloud")) == sorted(
            {f"iteration_{it or 24}" for it in stops})

"""The port's same-device scene batching against the JAX package:
``SceneTrainer.optimize_scene_batch`` against JAX's and against the port's
own ``optimize_scene`` per scene, and the batched sweep behind
``training.scene_batch`` against the JAX CLI's and the port's serial sweep.
The scenes of a batch have different rigs (so different extents, the xyz
LR scale) and initial poses spread by 30-50 mm."""

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
from skelsplat_tpu_torch.core.cameras import flatten_scenes, stack_cameras
from skelsplat_tpu_torch.core.gaussians import GaussianParams, SkeletonModel
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.engine.optim import AdamGroups, OptConfig
from skelsplat_tpu_torch.tools import make_synthetic_dataset
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J, W, H, NV = 17, 112, 96, 3
ITERS = 12
# (camera distance, focal) of each scene's rig, and its initial-pose spread
RIGS = ((3600.0, 1000.0), (4000.0, 1100.0), (4600.0, 1250.0))
SPREAD = (30.0, 40.0, 50.0)
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")
CLI_ITERS = 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's many small CPU ops on one torch thread: under the
    test run's parallel workers, an intra-op thread per core in every
    worker contends for the cores (it slowed this file ~10×)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _xyz_bar(ref):
    """1e-4 mm, or 4 float32 ulps of the value where that is larger (the
    two packages' rounding drifts by up to 3 ulps over 24 iterations)."""
    return np.maximum(1e-4, 4 * np.spacing(np.abs(ref).astype(np.float32)))


@pytest.fixture(scope="module")
def scenes():
    """B = 3 scenes, each with its own rig: (init, gt, p2d, JAX cameras
    with (B, V) numpy leaves, the port's (B, V) Camera, per-scene JAX
    cameras)."""
    rigs = [synthetic_rig(n_views=NV, width=W, height=H, dist=d, focal=f)[0]
            for d, f in RIGS]
    rng = np.random.default_rng(9)
    inits, gts, p2ds = [], [], []
    for cams, spread in zip(rigs, SPREAD):
        gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
        p2ds.append(np.stack([project_np(gt, take_cam(cams, v))
                              for v in range(NV)]).astype(np.float32))
        inits.append(gt + rng.normal(0, spread, gt.shape).astype(np.float32))
        gts.append(gt)
    jcams_b = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *rigs)
    tcams_b = compat.camera_from_numpy(jcams_b, device="cpu")
    return np.stack(inits), np.stack(gts), np.stack(p2ds), jcams_b, tcams_b, rigs


def _port(settings_kw, renderer="cuda", iterations=ITERS):
    return ttrainer.SceneTrainer(
        SkeletonModel("h36m", N_J, scaling=3.0),
        OptConfig(iterations=iterations),
        ttrainer.TrainSettings(**settings_kw), W, H, renderer=renderer,
        device="cpu")


def _jax(settings_kw, iterations=ITERS):
    return jtrainer.SceneTrainer(
        JModel("h36m", N_J, scaling=3.0), JOpt(iterations=iterations),
        jtrainer.TrainSettings(**settings_kw), W, H, renderer="fused")


@pytest.fixture(scope="module")
def jax_batches(scenes):
    """JAX's optimize_scene_batch per accumulation_steps, each run once."""
    init, gt, p2d, jcams_b = scenes[:4]
    cache = {}

    def run(accum):
        if accum not in cache:
            cache[accum] = _jax({"accumulation_steps": accum}) \
                .optimize_scene_batch(init, p2d, jcams_b, gt)
        return cache[accum]
    return run


# xyz bar against JAX, in mm. A joint coordinate whose gradient nearly
# cancels over the views (scene 1, joint 11, y: terms of ~2e-5 averaging to
# 5e-7) carries the packages' ~1e-6 relative rounding difference into Adam,
# whose normalized step (~lr·extent ≈ 2.4 mm) turns it into ~1e-4 mm per
# step: after 12 iterations the port's serial optimize_scene differs from
# JAX's serial one by 2.4e-4 mm (31 ulps) there, as its batch does from
# JAX's batch; over ten seeds of these rigs the largest such difference was
# 6.6e-4 mm. A wrong extent, visit order or stop would move xyz by ~0.1 mm
# a step. The batch itself adds nothing: it is bitwise the port's serial
# path (test_batch_matches_serial_port).
XYZ_ATOL = 1e-3


def _assert_batch_matches_jax(tp, th, jp, jh):
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


def test_scene_cameras_stack_and_flatten(scenes):
    """JAX's (B, V) Camera pytree carried across equals the port's stack of
    per-scene Cameras; flattening puts scene b's view v at b·V + v; each
    scene has its own extent."""
    *_, tcams_b, rigs = scenes
    per_scene = [compat.camera_from_numpy(jax.tree.map(np.asarray, c),
                                          device="cpu") for c in rigs]
    stacked = stack_cameras(per_scene)
    flat = flatten_scenes(stacked)
    for f in ("full4", "cam_center", "focal_x", "width", "uid"):
        assert torch.equal(getattr(stacked, f), getattr(tcams_b, f)), f
        assert getattr(flat, f).shape[0] == len(rigs) * NV
        for b in range(len(rigs)):
            for v in range(NV):
                assert torch.equal(getattr(flat, f)[b * NV + v],
                                   getattr(per_scene[b], f)[v]), (f, b, v)
    extents = [ttrainer.extent_from_centers(c.cam_center.numpy())
               for c in per_scene]
    assert len(set(extents)) == len(rigs), extents
    np.testing.assert_allclose(
        extents, [float(jtrainer.cameras_extent(c)) for c in rigs], rtol=1e-6)


def test_adam_steps_each_scene_with_its_own_extent():
    """A (B,) extent steps scene b's xyz as a scalar extent steps it alone,
    bitwise (the easy bug scales every scene by scene 0's extent)."""
    rng = np.random.default_rng(4)
    shapes = {"xyz": (N_J, 3), "log_scales": (N_J, 3), "quats": (N_J, 4),
              "opacity_logit": (N_J, 1)}
    B = 3
    adam = AdamGroups(OptConfig())
    p = GaussianParams(*(torch.as_tensor(
        rng.normal(0, 100, (B,) + shapes[f]).astype(np.float32))
        for f in FIELDS))
    extents = torch.tensor([3960.0, 4400.0, 5060.0])
    iteration = torch.tensor([4, 4, 3])
    state_b = adam.init(p)
    per = [(p.map(lambda x, b=b: x[b]), adam.init(p.map(lambda x, b=b: x[b])))
           for b in range(B)]
    assert state_b.t.shape == (B,)
    for step in range(3):
        g = GaussianParams(*(torch.as_tensor(
            rng.normal(0, 1e-3, (B,) + shapes[f]).astype(np.float32))
            for f in FIELDS))
        p, state_b = adam.step(p, g, state_b, iteration + 4 * step, extents)
        per = [adam.step(pb, g.map(lambda x, b=b: x[b]), sb,
                         iteration[b] + 4 * step, extents[b])
               for b, (pb, sb) in enumerate(per)]
        for b, (pb, sb) in enumerate(per):
            for f in FIELDS:
                assert torch.equal(getattr(p, f)[b], getattr(pb, f)), (f, b)
            assert torch.equal(state_b.v.xyz[b], sb.v.xyz)


@pytest.mark.parametrize("accum", [NV, 4], ids=["accum_eq_views",
                                                "accum_ne_views"])
@pytest.mark.parametrize("renderer", ["cuda", "fused"])
def test_batch_matches_jax(scenes, jax_batches, renderer, accum):
    """The port's batch (renderer "cuda": the kernel's plain version here;
    and "fused") against JAX's batch (renderer "fused"), for A = V and for
    A ≠ V (visits (k·4 + j) mod 3, stale accumulation rows)."""
    init, gt, p2d, _, tcams_b, _ = scenes
    tp, th = _port({"accumulation_steps": accum}, renderer) \
        .optimize_scene_batch(init, p2d, tcams_b, gt)
    jp, jh = jax_batches(accum)
    assert th.losses.shape == (3, ITERS // accum, accum)
    assert th.error.shape == (3, ITERS // accum, N_J)
    _assert_batch_matches_jax(tp, th, jp, jh)
    assert (th.stopped_at.numpy() == 0).all()
    assert bool((th.error[:, -1].mean(dim=1) < th.error[:, 0].mean(dim=1)).all())


@pytest.mark.parametrize("renderer", ["cuda", "fused", "dense"])
def test_batch_matches_serial_port(scenes, renderer):
    """Each scene of the port's batch is bitwise the port's optimize_scene
    of that scene: the batch only widens the view axis of each op."""
    init, gt, p2d, _, tcams_b, _ = scenes
    # 2 macro steps of (k·4 + j) mod 3 visits: stale rows in both
    trainer = _port({"accumulation_steps": 4}, renderer, iterations=8)
    pb, hb = trainer.optimize_scene_batch(init, p2d, tcams_b, gt)
    for b in range(init.shape[0]):
        p1, h1 = trainer.optimize_scene(init[b], p2d[b], tcams_b.take(b),
                                        gt[b])
        for f in FIELDS:
            assert torch.equal(getattr(pb, f)[b], getattr(p1, f)), (f, b)
        for f in ("losses", "error", "error_rel", "stopped_at"):
            assert torch.equal(getattr(hb, f)[b], getattr(h1, f)), (f, b)


def test_lean_batch_is_the_full_runs_last_row(scenes):
    init, gt, p2d, _, tcams_b, _ = scenes
    trainer = _port({"accumulation_steps": NV}, iterations=2 * NV)
    pf, hf = trainer.optimize_scene_batch(init, p2d, tcams_b, gt)
    pl, hl = trainer.optimize_scene_batch(init, p2d, tcams_b, gt, lean=True)
    for f in FIELDS:
        assert torch.equal(getattr(pl, f), getattr(pf, f)), f
    assert hl.losses.shape == (3, 1, NV) and hl.error.shape == (3, 1, N_J)
    for f in ("losses", "error", "error_rel"):
        assert torch.equal(getattr(hl, f)[:, 0], getattr(hf, f)[:, -1]), f
    assert torch.equal(hl.stopped_at, hf.stopped_at)


def test_batch_stops_each_scene_on_its_own(scenes):
    """Early stopping in a batch: scene 1's initial guess lies 1e7 mm off
    every frustum, so its heatmap loss is constant and only the limb prior
    (λ 1e-9: Adam still moves xyz ~lr·extent a step, the loss by ~1e-8)
    moves it; its fresh window fires the stop at iteration 8, and its
    parameters freeze there while scenes 0 and 2 run on. Against JAX's
    batch, and against the port's batch at twice the iterations."""
    init, gt, p2d, jcams_b, tcams_b, _ = scenes
    init = init.copy()
    init[1, :, 2] += 1e7
    kw = {"accumulation_steps": NV, "early_stopping": "opt_early_stopping",
          "lambda_consistency": 1e-9}
    tp, th = _port(kw).optimize_scene_batch(init, p2d, tcams_b, gt)
    jp, jh = _jax(kw).optimize_scene_batch(init, p2d, jcams_b, gt)
    assert th.stopped_at.tolist() == [0, 8, 0]
    _assert_batch_matches_jax(tp, th, jp, jh)
    moved = np.abs(tp.xyz[1].numpy() - init[1]).max()
    assert moved > 0.1, moved
    tp2, th2 = _port(kw, iterations=2 * ITERS).optimize_scene_batch(
        init, p2d, tcams_b, gt)
    assert th2.stopped_at.tolist() == [0, 8, 0]
    for f in FIELDS:
        assert torch.equal(getattr(tp2, f)[1], getattr(tp, f)[1]), f
    assert not torch.equal(tp2.xyz[0], tp.xyz[0])


# ---------------------------------------------------------------------------
# The batched sweep behind training.scene_batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "synth-h36m"
    assert make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 64, 64,
                                             image_size=96) == 4
    return str(root)


def _overrides(tree, run_dir, *extra):
    return [f"dataset.data_root={tree}", "dataset.end_scene_id=4",
            f"optimization.iterations={CLI_ITERS}",
            f"debug.save_iterations=[{CLI_ITERS}]", "debug.save_images=false",
            f"hydra.run.dir={run_dir}", *extra]


@pytest.fixture(scope="module")
def sweeps(tree, tmp_path_factory):
    """Run dirs of the JAX CLI and the port's at scene_batch=3 (a group of
    3 and a tail group of 1), and the port's at scene_batch=1."""
    import train as jtrain_cli

    exp = tmp_path_factory.mktemp("exp")
    runs = {k: str(exp / k) for k in ("jax", "port", "port_serial")}
    jtrain_cli.main(["--config-name", "h36m.yaml",
                     *_overrides(tree, runs["jax"], "training.scene_batch=3")])
    for k, batch in (("port", 3), ("port_serial", 1)):
        ttrain_cli.main(["--config-name", "h36m.yaml", "--device", "cpu",
                         *_overrides(tree, runs[k],
                                     f"training.scene_batch={batch}")])
    return runs


def _summary(run):
    return json.load(open(os.path.join(run, "train_summary.json")))


def test_batched_sweep_matches_jax_cli(sweeps):
    js, ts = _summary(sweeps["jax"]), _summary(sweeps["port"])
    assert sorted(ts) == sorted(js) == ["mean_seconds_per_scene", "scenes",
                                        "wall_clock_sweep_seconds",
                                        "wall_seconds_per_scene"]
    assert [s["scene_name"] for s in ts["scenes"]] == \
        [s["scene_name"] for s in js["scenes"]]
    assert len(ts["scenes"]) == 4
    for t, j in zip(ts["scenes"], js["scenes"]):
        assert sorted(t) == sorted(j) and t["scene_id"] == j["scene_id"]
        assert t["stopped_at"] == j["stopped_at"] == 0
        assert abs(t["abs_error"] - j["abs_error"]) < 1e-3
        assert abs(t["rel_error"] - j["rel_error"]) < 1e-3
    d = os.path.join("point_cloud", f"iteration_{CLI_ITERS}")
    names = sorted(os.listdir(os.path.join(sweeps["jax"], d)))
    assert sorted(os.listdir(os.path.join(sweeps["port"], d))) == names
    assert len(names) == 4
    for name in names:
        t = ply.read_ply(os.path.join(sweeps["port"], d, name))
        j = ply.read_ply(os.path.join(sweeps["jax"], d, name))
        assert list(t) == list(j)
        for f in ("x", "y", "z"):
            assert (np.abs(t[f] - j[f]) <= _xyz_bar(j[f])).all(), (name, f)
    # the batched path writes no debug PNGs
    assert not os.path.exists(os.path.join(sweeps["port"], "images"))


def test_batched_sweep_matches_serial_sweep(sweeps):
    b, s = _summary(sweeps["port"]), _summary(sweeps["port_serial"])
    assert s["pipelined_scenes"] is True and "pipelined_scenes" not in b
    for t, r in zip(b["scenes"], s["scenes"]):
        assert t["scene_name"] == r["scene_name"]
        assert abs(t["abs_error"] - r["abs_error"]) < 1e-3
        assert abs(t["rel_error"] - r["rel_error"]) < 1e-3
        name = os.path.join("point_cloud", f"iteration_{CLI_ITERS}",
                            f"{t['scene_name']}.ply")
        np.testing.assert_array_equal(
            ply.read_xyz(os.path.join(sweeps["port"], name)),
            ply.read_xyz(os.path.join(sweeps["port_serial"], name)))


def test_scene_batch_with_early_stopping_falls_back(tree, tmp_path):
    """scene_batch=3 with opt_early_stopping takes the per-scene path (the
    stopper's window spans scene boundaries): its summary is the serial
    path's, and its results equal a scene_batch=1 run exactly."""
    runs = {}
    for batch in (1, 3):
        run = str(tmp_path / f"b{batch}")
        ttrain_cli.main(["--config-name", "h36m.yaml", "--device", "cpu",
                         *_overrides(tree, run, f"training.scene_batch={batch}",
                                     "dataset.end_scene_id=2",
                                     "training.early_stopping="
                                     "opt_early_stopping")])
        runs[batch] = _summary(run)
    assert "pipelined_scenes" in runs[3]
    for a, b in zip(runs[1]["scenes"], runs[3]["scenes"]):
        assert a["scene_name"] == b["scene_name"]
        assert a["abs_error"] == b["abs_error"]
        assert a["rel_error"] == b["rel_error"]
        assert a["stopped_at"] == b["stopped_at"]

"""The port's CLI sweep against the JAX CLI: the root ``train.main`` /
``eval.main`` and ``skelsplat_tpu_torch.train.main`` / ``.eval.main``
(``--device cpu``) on one small synthetic H36M tree, and the trainer's
cross-scene early-stop window with noise injection against JAX's
``optimize_scene``."""

import filecmp
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import skelsplat_tpu.engine.trainer as jtrainer
import skelsplat_tpu_torch.engine.trainer as ttrainer
from skelsplat_tpu import evaluation as jeval
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch import eval as teval_cli
from skelsplat_tpu_torch import train as ttrain_cli
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.tools import make_synthetic_dataset
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

ITERS = (12, 24)
ROTATION_LR = 0.001   # h36m.yaml's optimization.rotation_lr


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
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "synth-h36m"
    assert make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 64, 64,
                                             image_size=96) == 4
    return str(root)


def _overrides(tree, run_dir):
    return [f"dataset.data_root={tree}", "dataset.end_scene_id=2",
            f"optimization.iterations={ITERS[-1]}",
            f"debug.save_iterations=[{ITERS[0]}, {ITERS[-1]}]",
            "debug.save_images=true", f"hydra.run.dir={run_dir}"]


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """The JAX CLI's and the port's run dirs over the same tree."""
    import train as jtrain_cli

    exp = tmp_path_factory.mktemp("exp")
    jrun, trun = str(exp / "jax"), str(exp / "port")
    jtrain_cli.main(["--config-name", "h36m.yaml", *_overrides(tree, jrun)])
    # the JAX driver's grouping knobs, as JAX's defaults set them (the
    # mid-run save and the debug PNGs keep this sweep off the chain)
    ttrain_cli.main(["--config-name", "h36m.yaml", "--device", "cpu",
                     *_overrides(tree, trun), "+training.pipeline_scenes=true",
                     "+training.fetch_scenes=8", "+training.chain_scenes=true"])
    return jrun, trun


def _xyz_bar(ref):
    """1e-4 mm, or 4 float32 ulps of the value where that is larger: after
    24 iterations the two packages' rounding differences have moved xyz by
    up to 3 ulps (1.8e-4 mm at 934.6 mm on this tree), whichever of the
    port's three renderers runs."""
    return np.maximum(1e-4, 4 * np.spacing(np.abs(ref).astype(np.float32)))


def test_cli_writes_what_the_jax_cli_writes(runs):
    jrun, trun = runs
    for name in ("input.ply", "cameras.json", os.path.join("sparse",
                                                           "points3D.ply")):
        assert filecmp.cmp(os.path.join(jrun, name), os.path.join(trun, name),
                           shallow=False), name
    js = json.load(open(os.path.join(jrun, "train_summary.json")))
    ts = json.load(open(os.path.join(trun, "train_summary.json")))
    assert sorted(ts) == sorted(js)
    assert ts["pipelined_scenes"] is js["pipelined_scenes"] is True
    assert [s["scene_name"] for s in ts["scenes"]] == \
        [s["scene_name"] for s in js["scenes"]]
    for t, j in zip(ts["scenes"], js["scenes"]):
        assert sorted(t) == sorted(j) and t["scene_id"] == j["scene_id"]
        assert t["stopped_at"] == j["stopped_at"] == 0
        assert abs(t["abs_error"] - j["abs_error"]) < 1e-3
        assert abs(t["rel_error"] - j["rel_error"]) < 1e-3
    for it in ITERS:
        d = os.path.join("point_cloud", f"iteration_{it}")
        names = sorted(os.listdir(os.path.join(jrun, d)))
        assert sorted(os.listdir(os.path.join(trun, d))) == names
        assert len(names) == 2
        for name in names:
            t = ply.read_ply(os.path.join(trun, d, name))
            j = ply.read_ply(os.path.join(jrun, d, name))
            assert list(t) == list(j)
            for f in ("x", "y", "z"):
                assert (np.abs(t[f] - j[f]) <= _xyz_bar(j[f])).all(), (it, f)
            for f in [k for k in j if k.startswith("scale_")]:
                np.testing.assert_allclose(t[f], j[f], rtol=1e-5, atol=1e-6)
            # a quaternion's gradient on a near-isotropic Gaussian is
            # rounding noise, which Adam (eps 1e-15) turns into steps of
            # ~rotation_lr: the packages' noise differs, so quats may part
            # by a few such steps
            for f in [k for k in j if k.startswith("rot_")]:
                np.testing.assert_allclose(t[f], j[f], rtol=0,
                                           atol=3 * ROTATION_LR)
            for f in [k for k in j if k.startswith(("n", "f_dc_", "opac"))]:
                np.testing.assert_array_equal(t[f], j[f])
    for d, stem in (("images", "render"), ("heatmaps", "heatmap")):
        for v in range(4):
            t, j = (np.asarray(Image.open(os.path.join(r, d, f"{stem}_{v}.png")),
                               dtype=np.int16) for r in (trun, jrun))
            assert t.shape == j.shape == (96, 96)
            assert np.abs(t - j).max() <= 1, (d, v)
            assert t.max() == 255


def test_evals_agree_and_read_each_others_runs(runs, tree, capsys):
    import eval as jeval_cli

    jrun, trun = runs
    args = ["--config-name", "h36m.yaml", f"dataset.data_root={tree}",
            "dataset.end_scene_id=2",
            f"debug.save_iterations=[{ITERS[0]}, {ITERS[-1]}]"]
    got = teval_cli.main(["--device", "cpu", *args,
                          f"eval.output_path={trun}"])
    gt = os.path.join(tree, "3d_gt")
    ref = jeval.evaluate(gt, jrun, list(ITERS), 0, 2)
    for it in ITERS:
        for k in ("absolute", "relative"):
            assert np.isfinite(got[it][k])
            assert abs(got[it][k] - ref[it][k]) < 1e-3, (it, k)
    assert got[ITERS[-1]]["absolute"] < got[ITERS[0]]["absolute"]
    # each package's eval reads the other's run dir
    np.testing.assert_equal(
        teval_cli.main(["--device", "cpu", *args, f"eval.output_path={jrun}"]),
        ref)
    capsys.readouterr()
    jeval_cli.main([*args, f"eval.output_path={trun}"])
    out = capsys.readouterr().out
    assert f"Absolute MPJPE:  {np.round(got[ITERS[-1]]['absolute'], 2)}" in out


def test_skip_existing_resumes_without_training(runs, tree):
    _, trun = runs
    summary = os.path.join(trun, "train_summary.json")
    before = json.load(open(summary))["scenes"]
    results = ttrain_cli.main(["--config-name", "h36m.yaml", "--device",
                               "cpu", *_overrides(tree, trun),
                               "+training.skip_existing=true"])
    assert results == before
    assert json.load(open(summary))["scenes"] == before


def test_early_stopped_scenes_save_under_their_stop_iteration(tree,
                                                              tmp_path):
    """Initial guesses moved 1e7 mm off every frustum render nothing, so
    the loss repeats and the stop fires in every scene (the limb prior,
    whose tiny gradients keep the loss moving, is off); the window carries
    over from scene to scene. Both CLIs save each scene under its stop
    iteration alone."""
    import shutil

    import train as jtrain_cli

    root = tmp_path / "synth-h36m"
    shutil.copytree(tree, root)
    for path in root.glob("initial_guess/**/poses.npz"):
        poses = np.load(path)["poses"]
        poses[..., 2] += 1e7
        np.savez(path, poses=poses)
    ovr = [f"dataset.data_root={root}", "dataset.end_scene_id=2",
           f"optimization.iterations={ITERS[-1]}",
           f"debug.save_iterations=[{ITERS[0]}, {ITERS[-1]}]",
           "debug.save_images=false", "training.consistency_loss=none",
           "training.early_stopping=opt_early_stopping"]
    jrun, trun = tmp_path / "jax", tmp_path / "port"
    jtrain_cli.main(["--config-name", "h36m.yaml", *ovr,
                     f"hydra.run.dir={jrun}"])
    ttrain_cli.main(["--config-name", "h36m.yaml", "--device", "cpu", *ovr,
                     f"hydra.run.dir={trun}"])
    js, ts = (json.load(open(r / "train_summary.json"))["scenes"]
              for r in (jrun, trun))
    stops = [s["stopped_at"] for s in ts]
    assert stops == [s["stopped_at"] for s in js]
    assert all(0 < it < ITERS[0] for it in stops), stops
    for r in (jrun, trun):
        assert sorted(os.listdir(r / "point_cloud")) == sorted(
            {f"iteration_{it}" for it in stops})
    for s in ts:
        name = os.path.join("point_cloud", f"iteration_{s['stopped_at']}",
                            f"{s['scene_name']}.ply")
        np.testing.assert_array_equal(ply.read_xyz(str(trun / name)),
                                      ply.read_xyz(str(jrun / name)))


@pytest.fixture
def restore_debug_nans():
    """The JAX CLI's pipeline.debug turns jax_debug_nans on for the
    process; put it back for the tests that follow."""
    before = jax.config.jax_debug_nans
    yield
    jax.config.update("jax_debug_nans", before)


@pytest.mark.parametrize("override", [
    "+training.multichip=true",
    "+training.view_fusion=confidence_weighted", "training.loss_function=l1",
    "pipeline.debug=true"])
def test_lifted_options_match_the_jax_cli(tree, tmp_path, override,
                                          restore_debug_nans):
    """Options the port once refused run as in the JAX CLI and write the
    same PLYs. Multichip: this test run gives JAX 8 CPU devices, so the
    JAX CLI takes its mesh path; the port on one device takes its serial
    path. The loss l1 runs the dense renderer in both. xyz within the
    1e-3 mm Adam bar of the batch tests (test_torch_batch.XYZ_ATOL)."""
    import train as jtrain_cli

    runs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for pkg, run in runs.items():
        args = ["--config-name", "h36m.yaml", *_overrides(tree, str(run)),
                "debug.save_images=false", override]
        stdout = sys.stdout   # train's safe_state replaces it
        try:
            if pkg == "jax":
                jtrain_cli.main(args)
            else:
                ttrain_cli.main(["--device", "cpu", *args])
        finally:
            sys.stdout = stdout
    js, ts = (json.load(open(r / "train_summary.json"))["scenes"]
              for r in (runs["jax"], runs["port"]))
    assert [t["scene_name"] for t in ts] == [j["scene_name"] for j in js]
    for t, j in zip(ts, js):
        assert abs(t["abs_error"] - j["abs_error"]) < 1e-3
    for it in ITERS:
        d = os.path.join("point_cloud", f"iteration_{it}")
        names = sorted(os.listdir(runs["jax"] / d))
        assert sorted(os.listdir(runs["port"] / d)) == names
        assert len(names) == 2
        for name in names:
            np.testing.assert_allclose(
                ply.read_xyz(str(runs["port"] / d / name)),
                ply.read_xyz(str(runs["jax"] / d / name)), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def scene():
    W, H, nv = 112, 96, 3
    cams, _, _ = synthetic_rig(n_views=nv, width=W, height=H)
    rng = np.random.default_rng(3)
    gt = synthetic_skeleton(17, rng=rng, spread=300.0)
    p2d = np.stack([project_np(gt, take_cam(cams, v))
                    for v in range(nv)]).astype(np.float32)
    init = gt + rng.normal(0, 50, gt.shape).astype(np.float32)
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    return cams, tcams, gt, p2d, init, W, H


def test_hist8_init_with_noise_matches_jax(scene, monkeypatch):
    """A finite carried-over window with every window "repeating" fires
    the stop at iteration 1 (at 8 from a fresh window), on a noised
    initial pose; checkpoints before the stop and the final window match
    too."""
    cams, tcams, gt, p2d, init, W, H = scene
    monkeypatch.setattr(jtrainer, "REPEAT_TOL", 1e6)
    monkeypatch.setattr(ttrainer, "REPEAT_TOL", 1e6)
    kw = dict(accumulation_steps=3, early_stopping="opt_early_stopping",
              std_dev_noise=20.0)
    hist8 = np.linspace(2.0, 3.0, 8).astype(np.float32)
    jt = jtrainer.SceneTrainer(JModel("h36m", 17, scaling=3.0),
                               JOpt(iterations=12),
                               jtrainer.TrainSettings(**kw), W, H,
                               renderer="fused")
    tt = ttrainer.SceneTrainer(SkeletonModel("h36m", 17, scaling=3.0),
                               OptConfig(iterations=12),
                               ttrainer.TrainSettings(**kw), W, H,
                               device="cpu")
    saves = {"jax": [], "port": []}
    jp, jh = jt.optimize_scene(
        init, p2d, cams, gt, hist8_init=hist8, checkpoint_iterations=[7, 12],
        checkpoint_fn=lambda it, p: saves["jax"].append((it, p.xyz)))
    tp, th = tt.optimize_scene(
        init, p2d, tcams, gt, hist8_init=torch.as_tensor(hist8),
        checkpoint_iterations=[7, 12],
        checkpoint_fn=lambda it, p: saves["port"].append((it, p.xyz)))
    assert int(th.stopped_at) == int(jh.stopped_at) == 1
    assert [it for it, _ in saves["port"]] == [it for it, _ in saves["jax"]] \
        == [6, 12]
    for (_, t), (_, j) in zip(saves["port"], saves["jax"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(th.hist8.numpy(), np.asarray(jh.hist8),
                               rtol=1e-5)
    np.testing.assert_allclose(th.losses.numpy(), np.asarray(jh.losses),
                               rtol=1e-5, atol=1e-7)
    # both packages noised the initial pose alike
    noised = tt.host_inputs(init, p2d, tcams)[0]
    np.testing.assert_array_equal(
        noised, jt.host_inputs(init, p2d, cams)[0])
    assert np.abs(noised - init).max() > 1.0

"""The port's multi-GPU mesh path on gloo ranks spawned on the CPU, against
JAX's ``multichip_optimize`` on conftest's virtual CPU devices and against
the port's own single-process paths: the sharded step on (scenes × views)
meshes (1,2) and (2,1), with early stopping, dropout and general
accumulation; the multichip CLI under two ranks; ``dryrun_multichip``.

Three groups of ranks are spawned in all (one for every mesh job, one for
the CLI, one for the dry run), each rank on one torch thread."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import skelsplat_tpu.engine.trainer as jtrainer
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu.parallel import choose_mesh as jchoose_mesh
from skelsplat_tpu.parallel import make_mesh as jmake_mesh
from skelsplat_tpu.parallel.mesh import multichip_optimize as jmultichip
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch import eval as teval_cli
from skelsplat_tpu_torch import train as ttrain_cli
from skelsplat_tpu_torch.core.cameras import FIELDS as CAM_FIELDS
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.parallel import choose_mesh, launch
from skelsplat_tpu_torch.parallel.dryrun import dryrun_multichip, optimize_jobs
from skelsplat_tpu_torch.tools import make_synthetic_dataset
from tests.test_torch_batch import XYZ_ATOL, _assert_batch_matches_jax
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J, W, H, NV = 17, 96, 80, 4
ITERS = 12
RIGS = ((3600.0, 1000.0), (4400.0, 1200.0))
PARAM_FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")
# the mesh jobs: (name, mesh, settings); "options" doctors scene 0 1e7 mm
# along z so that it stops, draws dropout masks and visits 2 of the 4
# views a macro step
JOBS = (("plain_1x2", (1, 2), {}),
        ("plain_2x1", (2, 1), {}),
        ("options_1x2", (1, 2), {"early_stopping": "opt_early_stopping",
                                 "consistency_loss": "none", "dropout": True,
                                 "accumulation_steps": 2}))
CLI_ITERS = (8, 16)
CLI_SCENES = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one torch thread here and in every spawned rank (a
    rank gets its parent's threads over the rank count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    """B = 2 scenes, each with its own rig: (init, gt, p2d, JAX (B, V)
    cameras, the port's (B, V) Camera, drop masks)."""
    rigs = [synthetic_rig(n_views=NV, width=W, height=H, dist=d, focal=f)[0]
            for d, f in RIGS]
    rng = np.random.default_rng(11)
    inits, gts, p2ds = [], [], []
    for cams in rigs:
        gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
        p2ds.append(np.stack([project_np(gt, take_cam(cams, v))
                              for v in range(NV)]).astype(np.float32))
        inits.append(gt + rng.normal(0, 40.0, gt.shape).astype(np.float32))
        gts.append(gt)
    jcams_b = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *rigs)
    gen = torch.Generator().manual_seed(0)
    drop = np.stack([hm.dropout_masks_torch(NV, N_J, gen) for _ in rigs])
    return (np.stack(inits), np.stack(gts), np.stack(p2ds), jcams_b,
            compat.camera_from_numpy(jcams_b, device="cpu"), drop)


def _inputs(scenes, name):
    init, gt, p2d, jcams_b, tcams_b, drop = scenes
    if name.startswith("options"):
        init = init.copy()
        init[0, :, 2] += 1e7
        return init, gt, p2d, jcams_b, tcams_b, drop
    return init, gt, p2d, jcams_b, tcams_b, None


@pytest.fixture(scope="module")
def mesh_runs(scenes, tmp_path_factory):
    """Every job of JOBS on one group of 2 spawned gloo ranks: {name:
    {field: array}}."""
    jobs = []
    for name, mesh, settings in JOBS:
        init, gt, p2d, jcams_b, _, drop = _inputs(scenes, name)
        jobs.append({"mesh": mesh, "settings": settings,
                     "opt": {"iterations": ITERS}, "scene_type": "h36m",
                     "scaling": 3.0, "width": W, "height": H,
                     "renderer": "cuda", "initial": init, "poses_2d": p2d,
                     "gt": gt, "drop": drop,
                     "cameras": {f: np.asarray(getattr(jcams_b, f))
                                 for f in CAM_FIELDS}})
    out = str(tmp_path_factory.mktemp("mesh") / "runs.npz")
    launch.spawn(2, optimize_jobs, jobs, out, "cpu")
    data = np.load(out)
    return {name: {k.split("/", 1)[1]: data[k] for k in data.files
                   if k.startswith(f"{i}/")}
            for i, (name, _, _) in enumerate(JOBS)}


def _port_trainer(settings):
    return SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                        OptConfig(iterations=ITERS), TrainSettings(**settings),
                        W, H, renderer="cuda", device="cpu")


@pytest.mark.parametrize("n_dev,nv", [(8, 4), (4, 4), (6, 4), (2, 4), (5, 4),
                                      (8, 5), (10, 5), (1, 4), (12, 6),
                                      (3, 3), (16, 4)])
def test_choose_mesh_is_jaxs(n_dev, nv):
    """The views axis takes the largest divisor of nviews that divides the
    rank count, as JAX's policy does (tests/test_parallel.py's cases)."""
    s, v = choose_mesh(n_dev, nv)
    assert (s, v) == jchoose_mesh(n_dev, nv)
    assert s * v == n_dev and nv % v == 0


def test_choose_mesh_refuses_empty_counts():
    with pytest.raises(ValueError):
        choose_mesh(0, 4)
    with pytest.raises(ValueError):
        choose_mesh(2, 0)


@pytest.mark.parametrize("name", ["plain_1x2", "plain_2x1"])
def test_mesh_run_is_bitwise_the_batch(mesh_runs, scenes, name):
    """A gather does no arithmetic and a view's render does not depend on
    the views beside it: each scene of the mesh run is bitwise the port's
    optimize_scene_batch of the same scenes."""
    init, gt, p2d, _, tcams_b, _ = _inputs(scenes, name)
    params, hist = _port_trainer({}).optimize_scene_batch(init, p2d, tcams_b,
                                                          gt)
    run = mesh_runs[name]
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(run[f], getattr(params, f).numpy(), f)
    for f in ("losses", "error", "stopped_at"):
        np.testing.assert_array_equal(run[f], getattr(hist, f).numpy(), f)


def test_mesh_options_are_bitwise_the_serial_path(mesh_runs, scenes):
    """Early stopping, dropout and general accumulation on the mesh: each
    scene is bitwise the port's optimize_scene with the same mask and a
    fresh stop window; scene 0 stops, scene 1 runs to the end."""
    init, gt, p2d, _, tcams_b, drop = _inputs(scenes, "options_1x2")
    trainer = _port_trainer(dict(JOBS[2][2]))
    run = mesh_runs["options_1x2"]
    for b in range(len(init)):
        params, hist = trainer.optimize_scene(init[b], p2d[b],
                                              tcams_b.take(b), gt[b],
                                              drop_mask=drop[b])
        for f in PARAM_FIELDS:
            np.testing.assert_array_equal(run[f][b],
                                          getattr(params, f).numpy(), f)
        for f in ("losses", "error", "stopped_at"):
            np.testing.assert_array_equal(run[f][b],
                                          getattr(hist, f).numpy(), f)
    assert run["stopped_at"][0] > 0 and run["stopped_at"][1] == 0


@pytest.mark.parametrize("name", [name for name, _, _ in JOBS])
def test_mesh_run_matches_jax_multichip(mesh_runs, scenes, name):
    """JAX's multichip_optimize on the same mesh shape of virtual CPU
    devices, at the batch tests' bars (xyz 1e-3 mm, losses rtol 1e-5)."""
    mesh, settings = next((m, s) for n, m, s in JOBS if n == name)
    init, gt, p2d, jcams_b, _, drop = _inputs(scenes, name)
    trainer = jtrainer.SceneTrainer(
        JModel("h36m", N_J, scaling=3.0), JOpt(iterations=ITERS),
        jtrainer.TrainSettings(**settings), W, H, renderer="fused")
    jp, jh = jmultichip(jmake_mesh(*mesh), trainer, init, p2d, jcams_b, gt,
                        drop_b=drop)
    run = mesh_runs[name]
    tp = compat.params_from_numpy(run, device="cpu")

    class _Hist:
        losses = torch.as_tensor(run["losses"])
        error = torch.as_tensor(run["error"])
        stopped_at = torch.as_tensor(run["stopped_at"])
    _assert_batch_matches_jax(tp, _Hist, jp, jh)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "synth-h36m"
    assert make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 64, 64,
                                             image_size=W) == 4
    return str(root)


def _cli_overrides(tree, run_dir):
    return [f"dataset.data_root={tree}",
            f"dataset.end_scene_id={CLI_SCENES}",
            f"optimization.iterations={CLI_ITERS[-1]}",
            f"debug.save_iterations=[{CLI_ITERS[0]}, {CLI_ITERS[-1]}]",
            f"hydra.run.dir={run_dir}"]


@pytest.fixture(scope="module")
def cli_runs(tree, tmp_path_factory):
    """The port's multichip CLI on 2 spawned gloo ranks (each in its own
    directory, the run dir relative), the JAX CLI's multichip sweep on the
    virtual devices and the port's serial CLI, over one tree."""
    import sys

    import train as jtrain_cli

    exp = tmp_path_factory.mktemp("exp")
    ranks = exp / "ranks"
    launch.spawn(2, ttrain_cli.main,
                 ["--device", "cpu", "--config-name", "h36m.yaml",
                  *_cli_overrides(tree, "run"), "training.multichip=true"],
                 rank_dir=str(ranks))
    jrun, srun = str(exp / "jax"), str(exp / "serial")
    jtrain_cli.main(["--config-name", "h36m.yaml",
                     *_cli_overrides(tree, jrun), "training.multichip=true"])
    stdout = sys.stdout   # safe_state replaces it
    try:
        ttrain_cli.main(["--device", "cpu", "--config-name", "h36m.yaml",
                         *_cli_overrides(tree, srun)])
    finally:
        sys.stdout = stdout
    return {"mesh": str(ranks / "rank0" / "run"), "jax": jrun,
            "serial": srun, "ranks": ranks}


def test_multichip_cli_matches_jax_and_serial(cli_runs, tree):
    """MPJPE of the 2-rank sweep within 1e-3 mm of the JAX CLI's multichip
    sweep and of the port's serial sweep at both saved iterations; the
    PLYs bitwise the serial sweep's, and the summary has JAX's keys."""
    evals = {k: teval_cli.main(["--device", "cpu", "--config-name",
                                "h36m.yaml",
                                *_cli_overrides(tree, cli_runs[k])[:-1],
                                f"eval.output_path={cli_runs[k]}"])
             for k in ("mesh", "jax", "serial")}
    for it in CLI_ITERS:
        for other in ("jax", "serial"):
            for kind in ("absolute", "relative"):
                assert abs(evals["mesh"][it][kind]
                           - evals[other][it][kind]) <= XYZ_ATOL, \
                    (it, other, kind)
        d = os.path.join("point_cloud", f"iteration_{it}")
        names = sorted(os.listdir(os.path.join(cli_runs["mesh"], d)))
        assert len(names) == CLI_SCENES
        for f in names:
            np.testing.assert_array_equal(
                ply.read_xyz(os.path.join(cli_runs["mesh"], d, f)),
                ply.read_xyz(os.path.join(cli_runs["serial"], d, f)))
    with open(os.path.join(cli_runs["mesh"], "train_summary.json")) as f:
        mine = json.load(f)
    with open(os.path.join(cli_runs["jax"], "train_summary.json")) as f:
        jaxs = json.load(f)
    assert set(mine) == set(jaxs)
    assert ([s["scene_name"] for s in mine["scenes"]]
            == [s["scene_name"] for s in jaxs["scenes"]])


def test_rank_1_writes_and_prints_nothing(cli_runs):
    ranks = cli_runs["ranks"]
    assert os.listdir(ranks / "rank1") == []
    assert (ranks / "rank1.stdout").read_text() == ""
    assert (ranks / "rank0.stdout").read_text() != ""


def test_dryrun_multichip_on_cpu_ranks():
    """Two gloo ranks, mesh (1, 2): the doctored scene stops at iteration
    8, the other runs all 16, and the kernel renderer's plain version
    agrees with the fused stream (checked inside the ranks)."""
    summary = dryrun_multichip(2, device="cpu")
    assert summary["mesh"] == [1, 2]
    assert summary["stopped_at"] == [8, 0]
    assert summary["max_abs_dxyz"] <= 1e-3


def test_entry_points_default_to_the_card(tmp_path):
    """``dryrun_multichip``, ``optimize_jobs`` and ``parity_study`` run on
    the card unless the caller passes the CPU: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from skelsplat_tpu_torch.tools import parity_study

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        optimize_jobs([], str(tmp_path / "jobs.npz"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        parity_study.main(["--scenes", "1", "--iterations", "4",
                           "--out", str(tmp_path / "parity")])
    assert os.listdir(tmp_path) == []

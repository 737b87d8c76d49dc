"""The port's benchmark entry point (``skelsplat_tpu_torch/bench.py``)
against the root ``bench.py`` of the JAX package: the same presets and
options (read from the root file's syntax tree, never imported), the same
dropout mask sequence, and the chained sweep's poses against JAX's
``optimize_scene_chain`` on the same scenes, masks and model."""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import skelsplat_tpu.engine.trainer as jtrainer
from skelsplat_tpu.core.gaussians import SkeletonModel as JModel
from skelsplat_tpu.engine.optim import OptConfig as JOpt
from skelsplat_tpu.ops import heatmaps as jhm
from skelsplat_tpu_torch import bench as tbench
from skelsplat_tpu_torch import graft_entry as tentry
from skelsplat_tpu_torch.tools import trace_summary

ROOT_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
FRAMES, ITERS = 2, 8
SMALL_ARGS = ["--device", "cpu", "--small", "--iterations", str(ITERS)]
# xyz bar against JAX's chain, in mm: the chain tests' (ROADMAP §3)
XYZ_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops on one torch thread: under the test run's
    parallel workers, an intra-op thread per core in every worker contends
    for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _root_main():
    with open(ROOT_BENCH) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_masks(n_scenes, n_views, n_joints):
    """The root bench's draws: ``dropout_masks_torch`` per scene after
    ``torch.manual_seed(0)``, on torch's global generator (restored
    after)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return [jhm.dropout_masks_torch(n_views, n_joints)
                for _ in range(n_scenes)]


def test_presets_are_the_root_benchs():
    assign = next(n for n in ast.walk(_root_main())
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "presets")
    assert tbench.PRESETS == ast.literal_eval(assign.value)


def test_options_are_the_root_benchs_and_device():
    root = {}
    for call in ast.walk(_root_main()):
        if (isinstance(call, ast.Call)
                and getattr(call.func, "attr", None) == "add_argument"):
            opt = ast.literal_eval(call.args[0])
            kw = {k.arg: k.value for k in call.keywords}
            root[opt] = {
                "default": (ast.literal_eval(kw["default"])
                            if "default" in kw else None),
                "choices": (ast.literal_eval(kw["choices"])
                            if "choices" in kw else None),
                "type": kw["type"].id if "type" in kw else None,
                "action": (ast.literal_eval(kw["action"])
                           if "action" in kw else None)}
    assert len(root) == 8
    port = {a.option_strings[0]: a for a in tbench.parser()._actions
            if a.option_strings[0] != "-h"}
    assert set(port) == set(root) | {"--device", "--program-trace"}
    assert port["--device"].default == "cuda"
    assert port["--program-trace"].default is None
    for opt, want in root.items():
        action = port[opt]
        assert action.default == (False if want["action"] == "store_true"
                                  else want["default"]), opt
        assert action.choices == want["choices"], opt
        assert (action.type.__name__ if action.type else None) == \
            want["type"], opt
        if want["action"] == "store_true":
            assert action.const is True and action.nargs == 0, opt


def test_dropout_masks_are_the_root_benchs():
    port = tbench.dropout_masks(6, 4, 17)
    want = _jax_masks(6, 4, 17)
    assert len(port) == 6
    for p, j in zip(port, want):
        assert p.dtype == j.dtype == bool and p.shape == (4, 17)
        np.testing.assert_array_equal(p, j)
    assert sum(int(p.sum()) for p in port) > 0


# each preset's run: its extra options. op's also times a batch and
# writes a profile, so that one run covers every part of the bench
RUN_OPTIONS = {"h36m-occ": [], "op": ["--batch", "2", "--profile"]}


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """``preset`` -> (results of ``bench.main``, its printed lines, the
    profile directory), each preset run once at FRAMES frames in one
    chained group."""
    runs = {}

    def get(preset):
        if preset not in runs:
            out = tmp_path_factory.mktemp(f"bench_{preset}")
            argv = SMALL_ARGS + ["--frames", str(FRAMES), "--group",
                                 str(FRAMES), "--preset", preset]
            argv += RUN_OPTIONS[preset]
            if "--profile" in argv:
                argv.append(str(out))
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res = tbench.main(argv)
            runs[preset] = res, printed.getvalue().splitlines(), out
        return runs[preset]
    return get


@pytest.mark.parametrize("preset", list(RUN_OPTIONS))
def test_prints_the_root_benchs_line(bench_run, preset):
    res, lines, _ = bench_run(preset)
    record = json.loads(lines[-1])
    assert list(record) == ["metric", "value", "unit", "vs_baseline"]
    assert record["metric"] == f"{preset}_frame_opt_seconds"
    assert record["unit"] == "s/frame"
    assert record["value"] == round(res["value"], 4) > 0
    assert record["vs_baseline"] == round(
        tbench.REF_SECONDS_PER_FRAME / res["value"], 3)
    assert len(res["frame_s"]) == FRAMES
    assert res["latency"] == np.median(res["frame_s"])


@pytest.mark.parametrize("preset", list(RUN_OPTIONS))
def test_sweep_matches_jax_chain(bench_run, preset):
    """The sweep's poses against JAX's chain of the same scenes: the root
    bench's inputs, masks and model, with JAX's fused renderer on the
    CPU."""
    res, _, _ = bench_run(preset)
    W, H = tbench.SMALL
    _, _, nj, scene_type, modifier, dropout = tbench.PRESETS[preset]
    n = FRAMES + 1
    init, gt, p2d, cams = jentry._synthetic_inputs(n, W, H, n_joints=nj)
    masks = _jax_masks(n, 4, nj) if dropout else [None] * n
    jt = jtrainer.SceneTrainer(
        JModel(scene_type, nj, scaling=3.0, scaling_modifier=modifier),
        JOpt(iterations=ITERS), jtrainer.TrainSettings(dropout=dropout),
        W, H, renderer="fused")
    jp, _ = jt.optimize_scene_chain(
        [jt.host_inputs(init[s], p2d[s], cams, gt[s], drop_mask=masks[s])
         for s in range(1, n)], lean=True)
    assert res["sweep_xyz"].shape == (FRAMES, nj, 3)
    np.testing.assert_allclose(res["sweep_xyz"], np.asarray(jp.xyz), rtol=0,
                               atol=XYZ_ATOL)
    assert np.abs(res["sweep_xyz"] - init[1:]).max() > 0.1


def test_sweep_is_the_serial_loop(bench_run):
    """h36m-occ's chained sweep bitwise ``optimize_scene`` scene by scene,
    with the same masks (which drop joints in the swept scenes)."""
    res, _, _ = bench_run("h36m-occ")
    W, H = tbench.SMALL
    nj = tbench.PRESETS["h36m-occ"][2]
    n = FRAMES + 1
    tr = tbench.make_trainer("h36m-occ", W, H, ITERS, "cpu")
    init, gt, p2d, cams = tentry._synthetic_inputs(n, W, H, n_joints=nj,
                                                   device="cpu")
    masks = tbench.dropout_masks(n, 4, nj)
    assert any(m.any() for m in masks[1:])
    serial = np.stack([tr.optimize_scene(
        init[s], p2d[s], cams, gt[s], lean=True,
        drop_mask=masks[s])[0].xyz.numpy() for s in range(1, n)])
    np.testing.assert_array_equal(res["sweep_xyz"], serial)


def test_sweep_alone_is_the_reported_value(bench_run):
    res, _, _ = bench_run("h36m-occ")
    assert res["value"] == res["sweep"] > 0
    assert res["batch"] is None and res["batch_xyz"] is None
    assert res["trace"] is None


def test_batch_is_the_reported_value(bench_run):
    res, _, _ = bench_run("op")
    assert res["batch_xyz"].shape == (2, 2, 15, 3)
    assert np.isfinite(res["batch_xyz"]).all()
    # two batches of the same scenes
    np.testing.assert_array_equal(res["batch_xyz"][0], res["batch_xyz"][1])
    assert res["value"] == res["batch"] > 0 and res["sweep"] > 0


def test_profile_is_a_trace_trace_summary_reads(bench_run):
    res, _, out = bench_run("op")
    assert res["trace"] == os.path.join(str(out), tbench.TRACE_FILE)
    events = trace_summary.load_trace_events(str(out))
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_the_card_is_required_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbench.run(["--small", "--frames", "1"])

"""The port's own tracing (``skelsplat_tpu_torch/tracing.py``) on the CPU:
the span tree of each public call of the trainer, on the eager path and
on the captured path's buffer logic; ``window``'s filter by host interval
and its flag where the ring dropped records; the chrome-trace export; the
profiler ranges; and results that detail tracing leaves bitwise alone.
Imports no JAX."""

import json
import time

import pytest
import torch

from skelsplat_tpu_torch import compat, tracing
from skelsplat_tpu_torch.core.cameras import stack_cameras
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.engine import graphs
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
from skelsplat_tpu_torch.synthetic import synthetic_inputs
from skelsplat_tpu_torch.utils import tree_leaves

W, H = 96, 80


@pytest.fixture(autouse=True)
def _fresh():
    """One thread, an empty ring and detail off, before and after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    tracing.enable(False)
    yield
    tracing.enable(False)
    tracing.clear()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    init, gt, p2d, cams_np = synthetic_inputs(4, W, H)
    return init, gt, p2d, compat.camera_from_numpy(cams_np, device="cpu")


def _trainer(iterations=8):
    return SceneTrainer(SkeletonModel("h36m", 17), OptConfig(iterations),
                        TrainSettings(), W, H, renderer="cuda", device="cpu")


def _calls(tr, scenes):
    """optimize_scene, a chain of 3 and a batch of 4; their results."""
    init, gt, p2d, cams = scenes
    one = tr.optimize_scene(init[0], p2d[0], cams, gt[0])
    chain = tr.optimize_scene_chain(
        [tr.host_inputs(init[s], p2d[s], cams, gt[s]) for s in range(3)])
    batch = tr.optimize_scene_batch(init, p2d, stack_cameras([cams] * 4), gt)
    return one, chain, batch


def _tree(recs):
    """(name, parent's name, unit's name, index) of each record."""
    by_id = {r.id: r for r in recs}
    return [(r.name, by_id[r.parent].name if r.parent is not None else None,
             by_id[r.unit].name if r.unit is not None else None, r.index)
            for r in recs]


SCENE = "skelsplat.scene"
CHAIN = "skelsplat.chain"
BATCH = "skelsplat.batch"
COPY = "skelsplat.input_copy"
LAUNCH = "skelsplat.launch"


def test_each_public_call_is_one_unit_with_its_spans(scenes):
    _calls(_trainer(), scenes)
    recs = tracing.records()
    assert _tree(recs) == [
        (SCENE, None, SCENE, None), (COPY, SCENE, SCENE, None),
        (LAUNCH, SCENE, SCENE, None),
        (CHAIN, None, CHAIN, None), (COPY, CHAIN, CHAIN, None),
        (LAUNCH, CHAIN, CHAIN, 0), (LAUNCH, CHAIN, CHAIN, 1),
        (LAUNCH, CHAIN, CHAIN, 2),
        (BATCH, None, BATCH, None), (COPY, BATCH, BATCH, None),
        (LAUNCH, BATCH, BATCH, None)]
    roots = [r for r in recs if r.unit == r.id]
    assert len({r.id for r in roots}) == 3
    for r in recs:
        unit = next(u for u in roots if u.id == r.unit)
        assert unit.t0 <= r.t0 <= r.t1 <= unit.t1
    # the packed copies, and no sync of a CPU tensor
    assert sum(r.counts[("input_bytes", "put_trees")] for r in roots) > 0
    assert tracing.counters["host_syncs"] == {}


def test_captured_path_spans_on_the_cpu(scenes, monkeypatch):
    """The captured path's buffer logic with each graph replaced by a
    call of its function: one load a call, one launch a scene, each
    chained scene with its index, and the stand-in's replays counted as
    graph launches of their program."""

    class Called:
        def __init__(self, fn, warmup, kind):
            self._fn, self.kind, self.graph = fn, kind, None

        def __call__(self):
            with tracing.replay(self.kind):
                out = self._fn()
            tracing.count("graph_launches", self.kind)
            return out

    monkeypatch.setattr(graphs, "Program", Called)
    monkeypatch.setattr(SceneTrainer, "captures", property(lambda s: True))
    tr = _trainer()
    _calls(tr, scenes)      # each shape's first prepare and collect are eager
    t0 = time.perf_counter()
    _calls(tr, scenes)
    t1 = time.perf_counter()
    tree = _tree([r for r in tracing.records() if r.t0 >= t0 * 1e9])
    assert [t for t in tree if t[0] == "skelsplat.load"] == [
        ("skelsplat.load", u, u, None) for u in (SCENE, CHAIN, BATCH)]
    assert [t for t in tree if t[0] == LAUNCH] == [
        (LAUNCH, SCENE, SCENE, None), (LAUNCH, CHAIN, CHAIN, 0),
        (LAUNCH, CHAIN, CHAIN, 1), (LAUNCH, CHAIN, CHAIN, 2),
        (LAUNCH, BATCH, BATCH, None)]
    win = tracing.window(t0, t1)
    n = tr.n_macro
    assert win["units"] == 3
    assert win["by_label"]["graph_launches"] == {
        "prepare": 5, "step": 5 * n, "collect": 3}
    assert win["scene_device_s"] is None and win["graph_gap_s"] is None
    assert win["scenes"] == 5 and win["replays"] == {}


def test_window_keeps_the_units_inside_its_interval(scenes):
    tr = _trainer()
    init, gt, p2d, cams = scenes
    marks = [time.perf_counter()]
    for s in range(3):
        tr.optimize_scene(init[s], p2d[s], cams, gt[s])
        marks.append(time.perf_counter())
    assert tracing.window(marks[0], marks[3])["units"] == 3
    one = tracing.window(marks[1], marks[2])
    assert one["units"] == 1 and not one["wrapped"]
    assert one["spans"][LAUNCH]["n"] == 1
    assert one["spans"][SCENE]["s"] <= marks[2] - marks[1]
    assert one["counters"]["graph_launches"] == 0
    # a unit cut by the interval's edge is left out
    assert tracing.window(marks[1] + 1e-4, marks[3])["units"] == 1
    assert tracing.window(marks[3], marks[3] + 1.0)["units"] == 0


def test_window_flags_records_the_ring_dropped():
    tracing.clear(size=8)
    t0 = time.perf_counter()
    for k in range(3):
        with tracing.unit(SCENE):
            with tracing.span("skelsplat.load"):
                pass
    t1 = time.perf_counter()
    assert not tracing.window(t0, t1)["wrapped"]
    for k in range(4):
        with tracing.unit(CHAIN):
            tracing.count("graph_launches", "step", 2)
    t2 = time.perf_counter()
    assert len(tracing.records()) == 8
    assert tracing.window(t0, t2)["wrapped"]
    late = tracing.window(t1, t2)
    assert not late["wrapped"] and late["units"] == 4
    assert late["counters"]["graph_launches"] == 8
    assert tracing.counters["graph_launches"]["step"] == 8


def test_device_work_held_in_a_capture_counts_once_a_replay():
    """A fake capture: the counts of device work made inside
    ``tracing.capturing`` (kernel launches, K1 calls by run length) reach
    neither the counters nor the unit; crediting the replay's record 3
    times counts each 3 times, with 3 graph launches; the host counts
    made meanwhile (the capture's sync, ``captures``) count once. Every
    kernel reads 0 until it launches."""
    from skelsplat_tpu_torch.ops import _build, cuda_raster

    assert cuda_raster.launches is tracing.counters["kernel_launches"]
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    with tracing.unit("skelsplat.scene") as unit:
        with tracing.capturing("step") as held:
            tracing.count("kernel_launches", "raster_loss_grad")
            tracing.count("kernel_launches", "compose_adam", 2)
            tracing.count("k1_run_length", "7")
            tracing.synced("graphs.capture")
        replay = tracing.Credit("step", held)
        assert replay.counts == {
            ("graph_launches", "step"): 1,
            ("kernel_launches", "raster_loss_grad"): 1,
            ("kernel_launches", "compose_adam"): 2, ("k1_run_length", "7"): 1}
        assert not tracing.counters["kernel_launches"]
        assert not tracing.counters["k1_run_length"]
        for _ in range(3):
            tracing.credit(replay)
    tracing.count("kernel_launches", "raster_loss")    # outside: at once
    assert _build.launch_counts() == {
        "raster_loss_grad": 3, "raster_loss": 1, "preprocess_pack": 0,
        "preprocess_grad": 0, "compose_adam": 6, "issue_rate": 0}
    assert tracing.counters["k1_run_length"] == {"7": 3}
    assert tracing.counters["graph_launches"] == {"step": 3}
    assert tracing.counters["host_syncs"] == {"graphs.capture": 1}
    assert tracing.counters["captures"] == {"step": 1}
    assert unit.counts == {("kernel_launches", "raster_loss_grad"): 3,
                           ("kernel_launches", "compose_adam"): 6,
                           ("k1_run_length", "7"): 3,
                           ("graph_launches", "step"): 3,
                           ("host_syncs", "graphs.capture"): 1,
                           ("captures", "step"): 1}


def test_export_writes_chrome_trace_json(scenes, tmp_path):
    _calls(_trainer(), scenes)
    path = tracing.export(str(tmp_path / "sub" / "trace.json"))
    data = json.loads(open(path).read())
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == len(tracing.records()) == 11
    for e in spans:
        assert e["cat"] == "span" and e["dur"] >= 0
        assert set(e["args"]) >= {"id", "parent", "unit"}
    assert [e["args"]["index"] for e in spans
            if e["name"] == LAUNCH and "index" in e["args"]] == [0, 1, 2]
    assert data["otherData"]["input_bytes"]["put_trees"] > 0


def test_spans_are_profiler_ranges_only_inside_a_session(scenes):
    from torch.profiler import ProfilerActivity, profile

    # outside a session nothing is handed to the profiler
    assert tracing.profiler_range("x") is tracing.section("y") is \
        tracing.replay("step")
    tr = _trainer()
    init, gt, p2d, cams = scenes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.optimize_scene(init[0], p2d[0], cams, gt[0])
    names = {e.name for e in prof.events()}
    assert {SCENE, COPY, LAUNCH} <= names
    # the step's sections are ranges only at the detail level
    assert "skelsplat.step.adam" not in names
    tracing.enable(detail=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.optimize_scene(init[0], p2d[0], cams, gt[0])
    names = {e.name for e in prof.events()}
    assert {f"skelsplat.step.{s}" for s in (
        "preprocess", "backward", "compose", "adam", "history")} <= names
    assert tracing.section("y") is tracing.profiler_range("x")


def test_detail_tracing_leaves_results_bitwise(scenes):
    tr = _trainer()
    off = _calls(tr, scenes)
    tracing.enable(detail=True)
    assert tracing.replay("step") is not tracing.profiler_range("x")
    on = _calls(tr, scenes)
    tracing.enable(False)
    for a, b in zip(tree_leaves(off), tree_leaves(on), strict=True):
        assert torch.equal(a, b)


def test_trace_summary_puts_kernels_under_the_section_open_at_launch(
        capsys):
    """``--by-range``: a kernel goes to the innermost ``skelsplat`` range
    open when it was launched, on any thread (the backward's launches come
    from autograd's thread while the caller waits in its range); a launch
    outside every such range is unattributed."""
    from skelsplat_tpu_torch.tools import trace_summary as tts

    def x(cat, name, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    events = [
        x("user_annotation", "skelsplat.step.preprocess", 1, 0, 50),
        x("cpu_op", "aten::mul", 1, 2, 5),
        x("cuda_runtime", "cudaLaunchKernel", 1, 3, 2, correlation=1),
        x("user_annotation", "skelsplat::raster_loss_grad", 1, 20, 10),
        x("cuda_runtime", "cudaLaunchKernel", 1, 22, 2, correlation=2),
        x("user_annotation", "skelsplat.step.backward", 1, 60, 40),
        x("cuda_runtime", "cudaLaunchKernel", 2, 70, 2, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 1, 120, 2, correlation=4),
        x("kernel", "mul", 0, 10, 4, correlation=1),
        x("kernel", "k1", 0, 30, 40, correlation=2),
        x("kernel", "bwd", 0, 80, 6, correlation=3),
        x("kernel", "copy", 0, 130, 1, correlation=4),
    ]
    assert tts.launching_ranges(events, "skelsplat") == {
        1: "skelsplat.step.preprocess", 2: "skelsplat::raster_loss_grad",
        3: "skelsplat.step.backward"}
    *_, by_range, n_range = tts.summarize(events, by_range="skelsplat")
    assert by_range == {"skelsplat::raster_loss_grad": 40,
                        "skelsplat.step.backward": 6,
                        "skelsplat.step.preprocess": 4, "<unattributed>": 1}
    assert sum(n_range.values()) == 4
    assert "launching range" in capsys.readouterr().out


def test_bench_writes_a_program_trace(tmp_path):
    """``bench.py --program-trace`` records every call with detail on and
    writes them as chrome-trace JSON; detail is off again after."""
    from skelsplat_tpu_torch import bench

    path = tmp_path / "program.json"
    out = bench.run(["--device", "cpu", "--small", "--frames", "1",
                     "--group", "1", "--iterations", "4",
                     "--program-trace", str(path)])
    assert out["program_trace"] == str(path)
    assert tracing.replay("step") is tracing.profiler_range("x")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"]
    # latency frames 0 and 1, the warm chain and the swept one
    assert names.count(SCENE) == 2 and names.count(CHAIN) == 2
    assert names.count(LAUNCH) == 4


def test_replay_states_splits_replays_by_their_scenes_state(tmp_path):
    """tools/replay_states puts each scene in the slow state when its
    device interval passes the split, each replay in its scene's state,
    and reduces device ms and the gaps before them per state and program;
    it reads a trace written (gzipped) as ``tracing.export`` writes it."""
    import gzip

    from skelsplat_tpu_torch.tools import replay_states

    events, rid = [], 0
    for scene, (step_ms, at_s) in enumerate([(1.5, 0.0), (1.3, 1.0),
                                             (1.3, 2.0)]):
        launch = rid
        events.append({"cat": "device", "name": tracing.LAUNCH,
                       "ts": at_s * 1e6, "args": {
                           "id": launch, "parent": None,
                           "device_ms": 125 * step_ms + 1,
                           "gap_ms": None if scene == 0 else 0.004}})
        for k in range(125):
            rid += 1
            events.append({"cat": "device", "name": tracing.REPLAY + "step",
                           "ts": at_s * 1e6 + k * 1e3, "args": {
                               "id": rid, "parent": launch,
                               "device_ms": step_ms, "gap_ms": 0.003}})
        rid += 1
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events + [{"ph": "M", "name": "x"}]}, f)
    out = replay_states.main(["--reduce", str(path), "--slow-ms", "180",
                              "--bin-s", "1"])
    assert out["scenes"] == {"slow": 1, "fast": 2}
    slow, fast = out["states"]["slow"], out["states"]["fast"]
    assert slow["step"]["n"] == 125 and fast["step"]["n"] == 250
    assert slow["step"]["device_ms"]["mean"] == pytest.approx(1.5)
    assert fast["step"]["device_ms"]["max"] == pytest.approx(1.3)
    assert fast["step"]["gap_us"]["median"] == pytest.approx(3.0)
    assert fast["launch"]["gap_us"]["p99"] == pytest.approx(4.0)
    assert slow["launch"]["gap_us"] == {}
    assert [b[1:] for b in out["bins"]] == [
        [pytest.approx(1.5), 125], [pytest.approx(1.3), 125],
        [pytest.approx(1.3), 125]]
    with pytest.raises(SystemExit):
        replay_states.main(["--slow-ms", "180"])

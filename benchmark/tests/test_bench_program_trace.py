"""The per-layer metrics that read the program's own tracing
(``skbench/program_trace.py`` and five readers under ``metrics/``): each
on a synthetic record, nothing where the program has no tracing module or
its ring dropped records of the window, and a tiny CPU cell run with
``--trace 1`` end to end."""

from __future__ import annotations

import json
import sys

import pytest

from conftest import make_tiny_root
from skbench import spec as specs, window

NEW = ("scene_device_ms_per_frame", "graph_gap_ms_per_frame",
       "launch_host_ms_per_frame", "graph_launches_per_frame",
       "host_syncs_per_frame")
# what the window of 64 frames read, as tracing.window returns it
TRACED = {"units": 2, "wrapped": False,
          "counters": {"graph_launches": 8128, "host_syncs": 0,
                       "captures": 0, "input_bytes": 1 << 20},
          "by_label": {}, "spans": {"skelsplat.launch": {"n": 64, "s": 9.6}},
          "scene_device_s": 10.56, "graph_gap_s": 0.032, "scenes": 64,
          "replays": {}}
WANT = {"scene_device_ms_per_frame": 165.0, "graph_gap_ms_per_frame": 0.5,
        "launch_host_ms_per_frame": 150.0, "graph_launches_per_frame": 127.0,
        "host_syncs_per_frame": 0.0}


def _record():
    w = window.Window(start=100.0, end=111.0)
    w.done = [(105.0, 0, 32), (111.0, 32, 32)]
    return {"window": w, "setup_s": 1.0, "trace": None}


def _readers(cell="h36m.chain32", suffix="tput"):
    s = specs.load(cell)
    return {name: s.reader(f"{name}.{suffix}") for name in NEW}


@pytest.fixture
def traced(monkeypatch):
    """``tracing.window`` answering ``TRACED``; the calls it got."""
    from skelsplat_tpu_torch import tracing

    calls = []

    def fake(t0, t1):
        calls.append((t0, t1))
        return dict(TRACED)

    monkeypatch.setattr(tracing, "window", fake)
    return calls


@pytest.mark.parametrize("cell,suffix", [("h36m.chain32", "tput"),
                                         ("h36m.online", "online")])
def test_each_reader_divides_the_window_by_its_frames(traced, cell, suffix):
    record = _record()
    for name, read in _readers(cell, suffix).items():
        assert read(record) == pytest.approx(WANT[name]), name
    # the window is asked for once a record, over the run's window
    assert traced == [(100.0, 111.0)]


def test_device_figures_are_none_without_a_gpu(monkeypatch):
    from skelsplat_tpu_torch import tracing

    monkeypatch.setattr(tracing, "window", lambda t0, t1: dict(
        TRACED, scene_device_s=None, graph_gap_s=None))
    got = {name: read(_record()) for name, read in _readers().items()}
    assert got["scene_device_ms_per_frame"] is None
    assert got["graph_gap_ms_per_frame"] is None
    assert got["graph_launches_per_frame"] == 127.0


@pytest.mark.parametrize("change", [{"wrapped": True}, {"units": 0}])
def test_nothing_is_read_from_a_dropped_or_empty_window(monkeypatch,
                                                        change):
    from skelsplat_tpu_torch import tracing

    monkeypatch.setattr(tracing, "window",
                        lambda t0, t1: dict(TRACED, **change))
    assert all(read(_record()) is None for read in _readers().values())


def test_nothing_is_read_without_the_module(monkeypatch):
    """An older program has no ``tracing`` module: every reader gives
    None and none raises."""
    import skelsplat_tpu_torch
    import skelsplat_tpu_torch.tracing  # noqa: F401 - then taken away

    monkeypatch.delattr(skelsplat_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "skelsplat_tpu_torch.tracing", None)
    assert all(read(_record()) is None for read in _readers().values())


@pytest.mark.parametrize("kind,suffix", [("chain", "tput"),
                                         ("online", "online")])
def test_a_traced_tiny_cell_reports_the_host_figures(tmp_path, capsys,
                                                     monkeypatch, kind,
                                                     suffix):
    """``tiny.<kind>`` with ``--trace 1`` on the CPU, the new metrics and
    the enqueue's listing it: the launch spans' host time (under the
    enqueue's), no
    graph launch (the CPU runs no captured program) and no host sync;
    the device figures are absent. Nothing here synchronizes a device."""
    import torch

    import run

    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in {f"{n}.{suffix}" for n in
                         NEW + ("dispatch_ms_per_frame",)}:
            m["workloads"].append(f"tiny.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rc = run.main(["--workload", f"tiny.{kind}", "--seed", str(2 ** 31 + 3),
                   "--seconds", "1", "--trace", "1"], root=root,
                  device="cpu")
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    got = {k.rsplit(".", 1)[0]: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == {"dispatch_ms_per_frame", "launch_host_ms_per_frame",
                        "graph_launches_per_frame", "host_syncs_per_frame"}
    assert 0 < got["launch_host_ms_per_frame"] <= got["dispatch_ms_per_frame"]
    assert got["graph_launches_per_frame"] == got["host_syncs_per_frame"] == 0

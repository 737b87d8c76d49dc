"""The harness on the CPU: what it finds by name, the window arithmetic,
the device idle share, the frozen K1 work count, and a cell that exists
only as new files in a temporary checkout, run end to end."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from conftest import REPO, run_cell
from skbench import k1work, spec as specs, trace, window

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    s = specs.load(cell)
    assert s.config["dataset"] == s.entry["config"].split(".")[0]
    loop = s.loop()
    for fn in ("warm", "run", "unit"):
        assert callable(getattr(loop, fn))
    assert any(m["name"] == "setup_s" for m in s.end_to_end)
    assert len(s.end_to_end) >= 2 and s.per_layer
    for m in s.end_to_end + s.per_layer:
        assert callable(s.reader(m["name"]))
    assert s.cell["check_frames"] > 0
    assert s.cell["limits"]["xyz_gap_p60_mm"] is not None


def test_benchmark_json_keeps_to_its_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and not c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)


def test_rate_counts_every_frame_over_the_whole_window():
    w = window.Window(start=10.0)
    for t, first, n in ((12.0, 0, 32), (14.0, 32, 32), (16.5, 64, 32)):
        w.done.append((t, first, n))
    w.end = 16.5
    assert w.frames == 96
    assert w.seconds == pytest.approx(6.5)
    q1, q4 = w.quarters()
    assert q1 == pytest.approx(2.0 / 32)
    assert q4 == pytest.approx(2.5 / 32)


@pytest.mark.parametrize("n", [199, 200, 400])
def test_p95_has_ten_frames_beyond_it_from_200_frames(n):
    values = list(np.random.default_rng(n).permutation(n) + 1.0)
    p95, beyond = window.percentile(values, 95)
    assert p95 == float(n - beyond)
    assert beyond == n - int(np.ceil(0.95 * n))
    assert (beyond >= 10) == (n >= 200)
    assert window.percentile(values, 50)[0] == float(np.ceil(n / 2))


def test_idle_share_is_the_union_of_device_intervals():
    ev = [  # µs; two kernels overlap, a copy, and a 30 µs gap
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 45, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 50, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "bench.fetch",
         "ts": 14, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 100},
    ]
    s = trace.summarize(ev)
    assert s["kernels"] == 3
    assert s["busy_s"] == pytest.approx(70e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernel_busy_s"] == pytest.approx(70e-6)
    assert s["breakdown"]["idle_gaps"] == [["bench.fetch",
                                            pytest.approx(30e-6)]]
    assert trace.union([(0, 1), (3, 4), (0.5, 2)]) == [[0, 2], [3, 4]]
    idle = specs.load("panoptic.batch128").reader("device_idle_share")
    assert idle({"trace": {"summary": s}}) == pytest.approx(0.3)


def test_a_split_metric_reads_from_the_file_of_its_stem():
    """``dispatch_ms_per_frame.tput`` and ``.online`` have no files of
    their own: both read ``metrics/dispatch_ms_per_frame.py``."""
    s = specs.load(CELLS[0])
    w = window.Window(start=0.0, spans=[(0.0, 0.5, 32), (1.0, 1.25, 32)])
    w.done = [(1.0, 0, 32), (2.0, 32, 32)]
    for name in ("dispatch_ms_per_frame.tput",
                 "dispatch_ms_per_frame.online"):
        assert not (REPO / f"benchmark/metrics/{name}.py").exists()
        assert s.reader(name)({"window": w}) == pytest.approx(750 / 64)
    with pytest.raises(FileNotFoundError):
        s.reader("no_such_metric.tput")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_frozen_k1_count_equals_the_program_roofline(seed):
    """The count from the cell's own inputs equals
    ``tools/roofline.py::kernel_bound`` on the program's slot records."""
    import torch

    from reference.fit import Reference
    from skbench import inputs
    from skelsplat_tpu_torch.core.cameras import camera_from_arrays
    from skelsplat_tpu_torch.core.gaussians import init_params
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.ops import heatmaps as hm
    from skelsplat_tpu_torch.ops import rasterizer
    from skelsplat_tpu_torch.tools import roofline

    cfg = json.loads((REPO / "benchmark/configs/h36m.json").read_text())
    cfg.update(width=160, height=144)
    W, H = cfg["width"], cfg["height"]
    cams = inputs.rig(cfg)
    init, _, p2d = inputs.frames(cfg, cams, seed, inputs.WINDOW, 0, 1)
    cam = camera_from_arrays(cams, "cpu")
    params = init_params(init[0], "h36m", 3.0, 1.0, device="cpu")
    spec = hm.heatmap_spec(params.xyz, params.covariance(),
                           torch.as_tensor(p2d[0]), cam, W, H)
    prof = cr.view_profiles(spec, W, H)
    pp = rasterizer.preprocess_gaussians(params.xyz, params.covariance(),
                                         params.opacity, cam, W, H)
    gd, aux, p1s, p2s = cr.slot_pack(pp, prof)
    pack = torch.cat([gd, aux], dim=-1).contiguous()
    want = roofline.kernel_bound(pack, p1s, p2s, prof.img, True)
    views = k1work.frame_views(Reference(cfg, cams), init, p2d)
    got = k1work.call_bound(views, H, W)
    assert (got["ops"], got["expf"], got["bytes"]) == (
        want["ops"], want["expf"], want["bytes"])
    assert got["ms"] == pytest.approx(want["published"][0])
    assert got["by"] == want["published"][1]


@pytest.mark.parametrize("kind", ["chain", "batch", "online"])
def test_a_cell_added_as_files_runs_end_to_end(tiny_root, capsys, kind):
    """``tiny.<kind>`` exists only in the temporary checkout: a new
    configuration, traffic mix and cell file, and new entries."""
    out = run_cell(tiny_root, f"tiny.{kind}", capsys)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checked"
    want = ({"frame_p50_ms", "frame_p95_ms", "setup_s"} if kind == "online"
            else {"frames_per_s", "setup_s"})
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_a_metric_and_a_loop_kind_added_as_files(tiny_root, capsys):
    """A new per-layer reader and a new loop kind, each one new file, are
    found by name."""
    root = tiny_root
    (root / "benchmark/loops/pairs.py").write_text(
        (root / "benchmark/loops/chain.py").read_text())
    (root / "benchmark/traffic/tiny_pairs.json").write_text(json.dumps(
        {"kind": "pairs", "group": 2, "in_flight": 2}))
    (root / "benchmark/workloads/tiny.pairs.json").write_text(json.dumps(
        {"check_frames": 2, "limits": {"xyz_gap_p60_mm": 0.05}}))
    (root / "benchmark/metrics/frames_in_window.py").write_text(
        "def read(record):\n    return float(record['window'].frames)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.pairs", "config": "tiny",
                               "traffic": "tiny_pairs", "chips": 1,
                               "why": "t"})
    bench["end_to_end"][0]["workloads"].append("tiny.pairs")
    bench["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "t", "moves": "frames_per_s",
                               "workloads": ["tiny.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    s = specs.load("tiny.pairs", root)
    assert [m["name"] for m in s.per_layer] == ["frames_in_window"]
    out = run_cell(root, "tiny.pairs", capsys)
    assert out["correct"] is True and "frames_per_s" in out["metrics"]

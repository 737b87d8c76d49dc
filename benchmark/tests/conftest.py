"""Fixtures of the benchmark's CPU tests: the repository and the benchmark
on the import path, and a checkout in a temporary directory that defines
small cells of its own (a configuration, three traffic mixes, their cells)
as new files and new ``BENCHMARK.json`` entries only.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "benchmark")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# a frame small enough for the CPU: the program's plain kernel versions
TINY = {"width": 96, "height": 80, "iterations": 8}
TINY_TRAFFIC = {
    "chain": {"kind": "chain", "group": 2, "in_flight": 3},
    "batch": {"kind": "batch", "batch": 4, "in_flight": 2},
    # a unit larger than the cell's sample of 4 frames
    "batch8": {"kind": "batch", "batch": 8, "in_flight": 2},
    "online": {"kind": "online"},
}
# far above what sound runs read at this size (~3e-4 mm), far below a
# frame the program left unfitted (tens of mm)
TINY_LIMIT_MM = 0.05


def make_tiny_root(root: Path) -> Path:
    """A copy of the benchmark under ``root`` with the cells
    ``tiny.<kind>`` of ``TINY_TRAFFIC`` added as files."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/h36m.json").read_text())
    cfg.update(TINY, reduced=sorted(TINY))
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": sorted(TINY), "why": "CPU tests"})
    for kind, traffic in TINY_TRAFFIC.items():
        (root / f"benchmark/traffic/tiny_{kind}.json").write_text(
            json.dumps(traffic))
        (root / f"benchmark/workloads/tiny.{kind}.json").write_text(
            json.dumps({"check_frames": 4,
                        "limits": {"xyz_gap_p60_mm": TINY_LIMIT_MM}}))
        bench["workloads"].append({"name": f"tiny.{kind}", "config": "tiny",
                                   "traffic": f"tiny_{kind}", "chips": 1,
                                   "why": "CPU tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"] += [f"tiny.{k}" for k in TINY_TRAFFIC
                               if k != "online"]
        elif "workloads" in m:
            m["workloads"].append("tiny.online")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cell(root: Path, cell: str, capsys, seconds: float = 1.0,
             seed: int = 2 ** 31 + 11) -> dict:
    """``run.main`` of ``cell`` on the CPU: the JSON line it printed."""
    import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0"], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])

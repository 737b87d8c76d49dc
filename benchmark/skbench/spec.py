"""What the harness finds by name: the cell's entry in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``), the
loop that the mix's ``kind`` names (``loops/<kind>.py``), the cell's own
file (``workloads/<cell>.json``: the correctness sample and limits) and a
reader per metric (``metrics/<metric>.py``, or the file of its name
without a last ``.suffix``; a ``read(record)`` function).
A later change adds any of them as new files and new entries, and edits
none that is there."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    """One cell as the files under ``root`` define it."""

    name: str
    root: Path
    entry: dict          # the workloads entry of BENCHMARK.json
    config: dict
    traffic: dict
    cell: dict           # workloads/<cell>.json
    end_to_end: list     # the metric entries this cell reports, by kind
    per_layer: list

    def loop(self):
        """The module of the traffic's loop kind."""
        kind = self.traffic["kind"]
        return _module(self.root / HERE / "loops" / f"{kind}.py",
                       f"bench_loop_{kind}")

    def reader(self, metric: str):
        """``read(record) -> float | None`` of a metric: from
        ``metrics/<metric>.py``, or where there is none, from the file of
        the name without its last ``.suffix``: one reading split by the
        end-to-end metric it moves (``dispatch_ms_per_frame.tput`` and
        ``.online``) keeps one file."""
        path = self.root / HERE / "metrics" / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = path.with_name(metric.rsplit(".", 1)[0] + ".py")
        return _module(path, "bench_metric_" + metric.replace(".", "_")).read


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or else every cell that reports the end-to-end metric it
    moves (every cell, for an end-to-end metric without the key)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load(name: str, root: Path = ROOT) -> Spec:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(root / HERE / "traffic" / f"{entry['traffic']}.json")
    cell = _json(root / HERE / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Spec(name, root, entry, config, traffic, cell, e2e, layer)

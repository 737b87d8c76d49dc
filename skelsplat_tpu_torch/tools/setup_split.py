"""A benchmark cell's set-up, split into its parts.

Runs the set-up of ``benchmark/run.py`` for one cell and seed, as that
script makes it, with a device synchronisation after each part, and prints
one JSON line of seconds: ``imports`` (from the process's start, torch and
the harness's modules included), ``cell`` (the trainer, the cameras and
the kernel library), ``warm`` (the loop's warm units, with their captures)
and ``setup``, their sum, which is the run's ``setup_s`` to within the
synchronisations. ``programs`` lists each captured program of the
trainer: its kind, its graph's nodes, and its capture and instantiation
seconds.

Usage, from the root of a checkout, on a machine with a card:
    python3 skelsplat_tpu_torch/tools/setup_split.py <cell> <seed>

Run it as a script, not with ``-m``: the package's import loads torch,
which would then fall outside ``imports``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

KINDS = ("prepare_program", "step_program", "collect_program")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    cell_name, seed = args[0], int(args[1])
    root = Path.cwd()
    here = Path(__file__).resolve().parent   # a script's own folder
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(root), str(root / "benchmark")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    marks = {}
    t = T_START

    def mark(name, since):
        torch.cuda.synchronize()
        now = time.perf_counter()
        marks[name] = round(now - since, 4)
        return now

    import run as benchrun
    from skbench import spec as specs

    t = mark("imports", t)
    spec = specs.load(cell_name, root)
    torch.set_num_threads(2)
    cell = benchrun.Cell(spec, seed, "cuda")
    t = mark("cell", t)
    spec.loop().warm(cell)
    mark("warm", t)
    marks["setup"] = round(time.perf_counter() - T_START, 4)
    marks["programs"] = [
        (kind, p.nodes, round(p.capture_seconds, 4),
         round(p.instantiate_seconds, 4))
        for g in cell.trainer.graphs.values() for kind in KINDS
        if (p := getattr(g, kind)) is not None and p.graph is not None]
    print(json.dumps(marks))
    return 0


if __name__ == "__main__":
    sys.exit(main())

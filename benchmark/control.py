"""The readings that a cell's limits are set from, on the card: for each
seed, the program through the cell's own loop for a short window and the
widest gap of a sample of its frames from the plain reference (the lower
reading, over a dozen seeds or more), and the control, the reference
computed in TF32, against the reference in float32 on the same frames
(the upper reading, over three seeds or more). The benchmark's own runs
never run this.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13
        [--seconds 0.001] [--no-program] [--control-seeds N] [--witness]

One JSON line per seed. For the program, and for the control put in its
place on the same sampled frames, it gives the numbers that ``correct``
compares beside the cell's limits (``skbench/check.py``), ``correct``
itself, and the sampled frames' widest joint gaps, sorted. The control's
``nonfinite_frames`` counts the sampled frames, the only ones it fits.
With ``--witness`` it gives the same of the reference run again with the
initial pose moved by one ulp, a second sound fit."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.001,
                    help="how long the loop sends units (it sends one at "
                         "least, and completes what it sent)")
    ap.add_argument("--no-program", action="store_true")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first this many seeds "
                         "(default: all)")
    ap.add_argument("--witness", action="store_true",
                    help="also fit the frames from the initial pose moved "
                         "by one ulp")
    args = ap.parse_args(argv)
    for p in (str(root), str(root / "benchmark")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import numpy as np
    import torch

    import run
    from skbench import check, inputs, spec as specs

    spec = specs.load(args.workload, root)
    torch.set_num_threads(2)
    cell = loop = None
    if not args.no_program:
        cell = run.Cell(spec, args.seeds[0], device)
        loop = spec.loop()
        loop.warm(cell)
    cams = inputs.rig(spec.config)
    out = []
    for seed in args.seeds:
        row = {"seed": seed}
        xyz = None
        if cell is not None:
            cell.seed = seed
            w = loop.run(cell, args.seconds)
            xyz, units = w.xyz(), w.units()
        else:
            units = [(0, spec.cell["check_frames"])]
        picked = check.sample(units, spec.cell["check_frames"], seed)
        ref = check.reference_fit(spec.config, cams, seed, picked, device)
        row["frames"] = len(picked)

        def put(name, poses):
            """``poses`` (frame → (N,3)) judged in the program's place."""
            checked, gaps = check.numbers(spec, poses, picked, ref)
            row[name] = {"correct": check.passed(checked),
                         "checked": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checked.items()},
                         "frames_mm": sorted(gaps.tolist())}

        if xyz is not None:
            put("program", xyz)
        if args.control_seeds is None or len(out) < args.control_seeds:
            put("control", dict(zip(picked, check.reference_fit(
                spec.config, cams, seed, picked, device, "tf32"))))
            if args.witness:
                put("witness", dict(zip(picked, check.reference_fit(
                    spec.config, cams, seed, picked, device, nudge=True))))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()

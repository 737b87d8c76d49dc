"""Run one cell of the benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell, its configuration, its traffic mix, its loop kind and its
metrics are found by name (``skbench/spec.py``). Set-up (imports, the
kernel library, the CUDA context, the trainer, the inputs, the captures
and the loop's warm units) runs first; then the loop sends units for
``--seconds`` and completes those in flight, and the window ends when the
last pose is on the host. With ``--trace 1`` the window also keeps host
spans around each enqueue call, and one more unit is profiled after it.
Then the program's state is freed and the plain reference fits a sample
of the window's frames again. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and ``checked`` (each number compared, beside its limit).

It measures the PyTorch and CUDA package ``skelsplat_tpu_torch`` only: it
exits with code 3, and prints no result, if ``jax``, ``jaxlib``, ``flax``
or the JAX package ``skelsplat_tpu`` is loaded in the process, and with
code 2 if the run asks for more cards than there are.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "skelsplat_tpu")
TRACE_FILE = "build/bench_trace/trace.json"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole (``skelsplat_tpu_torch`` is not
    ``skelsplat_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


class Cell:
    """What a loop drives: the program's trainer and cameras, and the
    cell's inputs from the seed."""

    def __init__(self, spec, seed: int, device):
        from skbench import inputs, program

        self.config, self.traffic = spec.config, spec.traffic
        self.seed = seed
        self.cams_np = inputs.rig(spec.config)
        self.cams = program.cameras(self.cams_np)
        self.trainer = program.make_trainer(spec.config, device)
        self.steps = spec.config["iterations"] // spec.config[
            "accumulation_steps"]

    def frames(self, stream: int, start: int, count: int):
        from skbench import inputs

        return inputs.frames(self.config, self.cams_np, self.seed, stream,
                             start, count)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def traced(spec, cell, loop) -> dict:
    """The profiled stretch: one unit of the traffic, its trace reduced,
    and K1's bound over the frames it ran."""
    from reference.fit import Reference
    from skbench import k1work, program, trace

    run_unit = loop.unit(cell)
    calls = []

    def counted():
        before = program.k1_launches()
        ran = run_unit()
        calls.append(program.k1_launches() - before)
        return ran

    def complete(summary):
        n = summary.get("kernel_n", {})
        return all(sum(c for name, c in n.items() if k in name) == calls[-1]
                   for k in k1work.KERNELS)

    summary, (stream, start, count) = trace.profile(
        counted, str(spec.root / TRACE_FILE), complete)
    cfg = spec.config
    init, _, p2d = (x for x in cell.frames(stream, start, count))
    views = k1work.frame_views(Reference(cfg, cell.cams_np, "cpu"), init, p2d)
    # a batch is one K1 call over all its views; a chained or single frame
    # one call over its own
    groups = [views] if spec.traffic["kind"] == "batch" else [[v]
                                                              for v in views]
    bounds = [k1work.call_bound(g, cfg["height"], cfg["width"])
              for g in groups]
    return {"summary": summary, "complete": complete(summary),
            "k1_calls": calls[-1], "frames": count, "steps": cell.steps,
            "k1_bound_ms": sum(b["ms"] for b in bounds) / len(bounds),
            "k1_bound": bounds[0]}


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> int:
    args = parser().parse_args(argv)
    for p in (str(root), str(root / "benchmark")):
        if p not in sys.path:
            sys.path.insert(0, p)
    found = forbidden_modules()
    if found:
        print(f"refusing to run: {found} loaded", file=sys.stderr)
        return 3
    import numpy as np
    import torch

    from skbench import check, program, spec as specs

    spec = specs.load(args.workload, root)
    chips = spec.entry["chips"]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"{args.workload} needs {chips} CUDA card(s); this process "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = Cell(spec, args.seed, device)
    loop = spec.loop()
    loop.warm(cell)
    setup_s = time.perf_counter() - T_START

    k1_before = program.k1_launches()
    w = loop.run(cell, args.seconds, spans=bool(args.trace))
    k1_window = program.k1_launches() - k1_before
    found = forbidden_modules()
    if found:
        print(f"after the window: {found} loaded", file=sys.stderr)
        return 3
    tr = traced(spec, cell, loop) if args.trace else None
    on_card = device == "cuda"
    mem = torch.cuda.max_memory_allocated() if on_card else 0
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": chips if on_card else 0,
           "memory_peak_bytes": int(mem)}
    if on_card:
        dev["power_limit"] = power_limit()
    if tr is not None and tr["summary"].get("kernels"):
        dev["busy_s"] = tr["summary"]["busy_s"]
        dev["window_s"] = tr["summary"]["window_s"]

    xyz = w.xyz()
    failed = sum(not np.isfinite(v).all() for v in xyz.values())
    # the program's state goes before the reference runs
    cams_np = cell.cams_np
    del cell, loop
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, gaps = check.check(spec, cams_np, args.seed, xyz, w.units(),
                                  device)
    correct = check.passed(numbers)
    t_check = time.perf_counter() - t_check

    record = {"window": w, "setup_s": setup_s, "trace": tr}
    metrics = {}
    for m in (spec.per_layer if args.trace else spec.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    q1, q4 = w.quarters()
    log = sys.stderr
    print(f"cell {spec.name} seed {args.seed}: {w.frames} frames in "
          f"{w.seconds:.6f} s ({args.seconds} s of sending), set-up "
          f"{setup_s:.6f} s", file=log)
    print(f"speed state: first quarter {q1:.6f} s/frame, last quarter "
          f"{q4:.6f} s/frame", file=log)
    print(f"K1 launches in the window: {k1_window} "
          f"({k1_window / max(w.frames, 1):.3f} a frame)", file=log)
    print(f"peak device memory: {mem} bytes on {dev['kind']}, power limit "
          f"{dev.get('power_limit')}", file=log)
    if tr is not None:
        s = tr["summary"]
        print(f"traced unit: {tr['frames']} frame(s), {s.get('kernels')} "
              f"kernel records, K1 calls {tr['k1_calls']}, complete "
              f"{tr['complete']}, K1 bound {tr['k1_bound_ms']:.6f} ms "
              f"({tr['k1_bound']['by']})", file=log)
    ref_mem = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"reference check: {t_check:.3f} s, peak device memory with it "
          f"{ref_mem} bytes; sampled frames' widest joint gaps (mm, not "
          f"compared one by one): {sorted(gaps.tolist())}", file=log)
    for name, (value, limit) in numbers.items():
        print(f"check {name}: {value} (limit {limit})", file=log)

    result = {"correct": correct, "attempted": w.frames, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None and tr["summary"].get("kernels"):
        result["breakdown"] = tr["summary"]["breakdown"]
    result["checked"] = {name: {"value": value, "limit": limit}
                         for name, (value, limit) in numbers.items()}
    found = forbidden_modules()
    if found:
        print(f"at the end: {found} loaded", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

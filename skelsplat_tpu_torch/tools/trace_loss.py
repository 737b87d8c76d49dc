"""How often torch.profiler drops kernel records from a short traced round,
with and without the padding of ``tools/timing.py::profiled_round``.

Alternates two layouts of a traced round of K1 launches, each after a
warm-up round as ``cuda_ms`` and ``chip_smoke.py`` trace:

* ``bare``: the launches, a device sync, the profiler step;
* ``padded``: the same inside ``profiled_round`` (host idle before the
  launches and after the sync).

Each trace is read back with ``trace_summary``: a launch inside the K1
wrapper's range whose kernel has no device record is lost. Prints, per
layout, the traces with losses, the records lost, where in the round the
lost launches sat, and the lowest kernel start minus launch (the
profiler's device-to-host clock error).

It profiles the GPU, so it needs one and raises without one.

Usage:
    python -m skelsplat_tpu_torch.tools.trace_loss [--seconds 120]
        [--launches 5]
"""

from __future__ import annotations

import argparse
import collections
import os
import tempfile
import time

import torch

from skelsplat_tpu_torch.ops import cuda_raster as cr
from skelsplat_tpu_torch.tools import kernel_probe, trace_summary
from skelsplat_tpu_torch.tools.timing import profiled_round

LAYOUTS = ("bare", "padded")
K1_RANGE = "skelsplat::raster_loss_grad"


def bare_round(prof, fn, reps: int) -> None:
    """``profiled_round`` without the idle edges."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    prof.step()


def traced(fn, reps: int, layout: str, path: str):
    """(positions of the K1 launches whose kernel record is missing, K1
    launches recorded, lowest kernel start minus launch in µs or None) of
    one trace of ``reps`` calls of ``fn`` in ``layout``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    run = profiled_round if layout == "padded" else bare_round
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(2):
            run(prof, fn, reps)
    events = trace_summary.load_trace_events(path)
    launches = sorted(trace_summary.range_launches(events, K1_RANGE))
    have = {ev.get("args", {}).get("correlation")
            for ev in trace_summary.device_events(events)}
    offs = trace_summary.launch_offsets(events)
    return ([i for i, c in enumerate(launches) if c not in have],
            len(launches), min(offs.values()) if offs else None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="alternate the layouts for this long")
    ap.add_argument("--launches", type=int, default=5,
                    help="K1 calls per round (2 kernels each)")
    args = ap.parse_args(argv)
    from skelsplat_tpu_torch.tools.timing import card_line

    pack, p1s, p2s, img = kernel_probe.probe_inputs(device="cuda")
    card = card_line()

    def k1():
        cr.raster_loss_grad(pack, p1s, p2s, img, False)

    n, bad, lost = (collections.Counter() for _ in range(3))
    where = {layout: collections.Counter() for layout in LAYOUTS}
    lowest = {layout: [] for layout in LAYOUTS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        while time.perf_counter() - t0 < args.seconds:
            for layout in LAYOUTS:
                missing, total, low = traced(k1, args.launches, layout, path)
                if total != 2 * args.launches:
                    raise RuntimeError(f"{total} K1 launches recorded in a "
                                       f"round of {args.launches} calls")
                n[layout] += 1
                if low is not None:
                    lowest[layout].append(low)
                if missing:
                    bad[layout] += 1
                    lost[layout] += len(missing)
                    where[layout].update(missing)
    out = {"card": card}
    for layout in LAYOUTS:
        lows = sorted(lowest[layout])
        out[layout] = {"traces": n[layout], "with_losses": bad[layout],
                       "records_lost": lost[layout],
                       "lowest_offset_us": lows[0] if lows else None}
        print(f"{layout:>6}: {bad[layout]} of {n[layout]} traces lost "
              f"records ({lost[layout]} of {n[layout] * 2 * args.launches}; "
              f"by launch position {dict(sorted(where[layout].items()))}); "
              f"kernel start minus launch, lowest per trace: "
              f"{lows[0] if lows else float('nan'):.1f} us at the least, "
              f"median {lows[len(lows) // 2] if lows else float('nan'):.1f} "
              f"us; on {card}", flush=True)
    return out


if __name__ == "__main__":
    main()

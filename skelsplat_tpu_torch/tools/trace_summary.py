"""Summarize a ``torch.profiler`` trace: top device kernels by total time
(counterpart of ``skelsplat_tpu/tools/trace_summary.py``).

Reads the chrome-trace JSON that ``prof.export_chrome_trace(path)`` (or
the tensorboard trace handler) writes, plain or gzipped, and reports each
GPU kernel, memcpy and memset by exclusive time. ``--by-op`` attributes
every kernel to the CPU op that launched it: a kernel event carries the
``correlation`` id of its runtime launch event (``cudaLaunchKernel`` and
kin), and that launch nests inside its op (an aten op, or a
``record_function`` range such as the port's ``skelsplat::raster_loss_grad``)
on the launching thread's lane. ``--by-range PREFIX`` attributes every
kernel instead to the innermost ``record_function`` range named PREFIX...
open when it was launched, on any thread (autograd launches a backward's
kernels from its own thread while the caller waits inside its range):
with ``tracing.enable(detail=True)`` the sections of the port's eager
macro step (``skelsplat.step.*``, K1's ``skelsplat::raster_loss_grad``).

Usage:
    python -m skelsplat_tpu_torch.tools.trace_summary TRACE [--top 30]
        [--macros N] [--by-op] [--by-range PREFIX]

TRACE is a ``.json`` / ``.json.gz`` file or a directory searched for them.
With ``--macros N`` every total is also divided by N (e.g. 125 macro steps
for the 500-iteration config).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

# torch.profiler's chrome-trace categories
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")


def load_trace_events(path: str):
    """All complete ('ph' == 'X') events of the trace file ``path``, or of
    every ``*.json`` / ``*.json.gz`` under the directory ``path``, with
    their process and thread names resolved into ``_proc`` / ``_thread``."""
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                 recursive=True)
                       + glob.glob(os.path.join(path, "**", "*.json.gz"),
                                   recursive=True))
        if not paths:
            raise FileNotFoundError(f"no *.json[.gz] trace under {path}")
    else:
        paths = [path]
    events = []
    for p in paths:
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            data = json.load(f)
        names = {}
        file_events = []
        for ev in data.get("traceEvents", []):
            ph = ev.get("ph")
            if ph == "M" and ev.get("name") in ("process_name",
                                                "thread_name"):
                key = (ev.get("pid"), ev.get("tid") if ev["name"] ==
                       "thread_name" else None)
                names[key] = ev.get("args", {}).get("name", "")
            elif ph == "X":
                file_events.append(ev)
        for ev in file_events:
            ev["_proc"] = names.get((ev.get("pid"), None), "")
            ev["_thread"] = names.get((ev.get("pid"), ev.get("tid")), "")
        events += file_events
    return events


def device_events(events):
    """GPU kernel, memcpy and memset events, by their ``cat``."""
    return [ev for ev in events if ev.get("cat") in DEVICE_CATS]


def exclusive_times(events):
    """Per-name EXCLUSIVE (self) durations via event containment.

    Trace timelines nest, so summing raw durations double-counts every
    level of the hierarchy. Per (pid, tid) lane, a sweep with a
    containment stack subtracts each child's duration from its parent."""
    lanes = collections.defaultdict(list)
    for ev in events:
        lanes[(ev.get("pid"), ev.get("tid"))].append(ev)
    self_time = collections.Counter()
    counts = collections.Counter()
    for evs in lanes.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # (ts, dur, name)
        for ev in evs:
            ts, dur = ev["ts"], ev.get("dur", 0)
            while stack and ts >= stack[-1][0] + stack[-1][1]:
                stack.pop()
            self_time[ev["name"]] += dur
            counts[ev["name"]] += 1
            if stack:
                self_time[stack[-1][2]] -= dur
            stack.append((ts, dur, ev["name"]))
    return self_time, counts


def launching_ops(events) -> dict:
    """{correlation id: name of the innermost CPU op around its runtime
    launch event}, by one containment sweep per (pid, tid) lane. Launches
    outside any op are left out."""
    lanes = collections.defaultdict(list)
    for ev in events:
        cat = ev.get("cat")
        if cat in OP_CATS or (cat in RUNTIME_CATS and "correlation"
                              in ev.get("args", {})):
            lanes[(ev.get("pid"), ev.get("tid"))].append(ev)
    out = {}
    for evs in lanes.values():
        # at one timestamp the longer event opens first, ops before launches
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0),
                                e.get("cat") not in OP_CATS))
        stack = []  # open ops
        for ev in evs:
            while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1].get("dur", 0):
                stack.pop()
            if ev.get("cat") in OP_CATS:
                stack.append(ev)
            elif stack:
                out[ev["args"]["correlation"]] = stack[-1]["name"]
    return out


def launching_ranges(events, prefix: str) -> dict:
    """{correlation id: name of the innermost ``user_annotation`` range
    whose name starts with ``prefix`` and that was open at its runtime
    launch event's start}, over every lane: one sweep, the ranges nesting
    as the calling thread opened them."""
    marks = sorted(
        [(ev["ts"], 0, -ev.get("dur", 0), ev) for ev in events
         if ev.get("cat") == "user_annotation"
         and ev.get("name", "").startswith(prefix)]
        + [(ev["ts"], 1, 0, ev) for ev in events
           if ev.get("cat") in RUNTIME_CATS
           and "correlation" in ev.get("args", {})], key=lambda m: m[:3])
    out, stack = {}, []
    for ts, is_launch, _, ev in marks:
        while stack and ts >= stack[-1]["ts"] + stack[-1].get("dur", 0):
            stack.pop()
        if not is_launch:
            stack.append(ev)
        elif stack:
            out[ev["args"]["correlation"]] = stack[-1]["name"]
    return out


def range_launches(events, op: str) -> set:
    """Correlation ids of the runtime kernel launches (``cudaLaunchKernel``
    and kin) whose innermost enclosing CPU op is named ``op``. These are
    host records: a launch is here even when the profiler dropped its
    kernel's device record."""
    launch = {ev["args"]["correlation"] for ev in events
              if ev.get("cat") in RUNTIME_CATS
              and "LaunchKernel" in ev.get("name", "")
              and "correlation" in ev.get("args", {})}
    return {c for c, name in launching_ops(events).items()
            if name == op and c in launch}


def launch_offsets(events) -> dict:
    """{correlation id: device event start minus the start of its runtime
    launch event, in µs} for every device event whose launch was recorded.
    A kernel cannot start before its launch call, so a negative offset is
    the error of the profiler's device-to-host clock conversion."""
    launch_ts = {ev["args"]["correlation"]: ev["ts"] for ev in events
                 if ev.get("cat") in RUNTIME_CATS
                 and "correlation" in ev.get("args", {})}
    return {c: ev["ts"] - launch_ts[c] for ev in device_events(events)
            if (c := ev.get("args", {}).get("correlation")) in launch_ts}


def summarize(events, top: int = 30, macros: int | None = None,
              out=print, by_op: bool = False, by_range: str | None = None):
    """Top device kernels of a trace's events (all of them: ``--by-op``
    reads the runtime and CPU-op events too). Returns (self time, count)
    per kernel name and, with ``by_op`` (or ``by_range``, the prefix of
    the ranges), (self time, count) per launching op (or range), else
    (None, None)."""
    dev = device_events(events)
    per_k, counts = exclusive_times(dev)
    total = sum(per_k.values())
    out(f"{len(dev)} device events, {total / 1e3:.3f} ms exclusive")
    if macros:
        out(f"per-macro ({macros} steps): {total / macros:.1f} us")
    out(f"{'kernel':<60} {'self ms':>9} {'n':>6} {'us/call':>8}"
        + (f" {'us/macro':>9}" if macros else ""))
    for name, dur in per_k.most_common(top):
        row = (f"{name[:60]:<60} {dur / 1e3:>9.3f} {counts[name]:>6} "
               f"{dur / max(counts[name], 1):>8.1f}")
        if macros:
            row += f" {dur / macros:>9.2f}"
        out(row)
    if not by_op and by_range is None:
        return per_k, counts, None, None
    op_of = (launching_ops(events) if by_range is None
             else launching_ranges(events, by_range))
    by_src, n_src = collections.Counter(), collections.Counter()
    for ev in dev:
        src = op_of.get(ev.get("args", {}).get("correlation"),
                        "<unattributed>")
        by_src[src] += ev.get("dur", 0)
        n_src[src] += 1
    out("")
    out(f"{'launching ' + ('op' if by_range is None else 'range'):<60} "
        f"{'self ms':>9} {'#kern':>6}"
        + (f" {'us/macro':>9}" if macros else ""))
    for src, dur in by_src.most_common(top):
        row = f"{src[:60]:<60} {dur / 1e3:>9.3f} {n_src[src]:>6}"
        if macros:
            row += f" {dur / macros:>9.2f}"
        out(row)
    return per_k, counts, by_src, n_src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="chrome-trace .json[.gz] or a directory")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--macros", type=int, default=None,
                    help="divide totals by this macro-step count")
    ap.add_argument("--by-op", action="store_true",
                    help="attribute each kernel to the CPU op that launched "
                         "it and add a per-op rollup")
    ap.add_argument("--by-range", default=None, metavar="PREFIX",
                    help="attribute each kernel to the innermost range "
                         "named PREFIX... open at its launch, on any "
                         "thread, and add a per-range rollup")
    args = ap.parse_args(argv)
    events = load_trace_events(args.trace)
    if not device_events(events):
        cats = collections.Counter(e.get("cat", "") for e in events)
        print("no device events found; categories present:")
        for cat, n in cats.most_common(20):
            print(f"  {n:>7}  {cat}")
        return None
    return summarize(events, top=args.top, macros=args.macros,
                     by_op=args.by_op, by_range=args.by_range)


if __name__ == "__main__":
    main()

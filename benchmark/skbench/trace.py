"""The traced stretch and its reduction: ``torch.profiler`` over one unit of
the cell's traffic, and the arithmetic that turns its device records into
the record that per-layer metric readers read.

The event arithmetic (``load_trace_events``, ``device_events``,
``exclusive_times``) is a frozen copy of
``skelsplat_tpu_torch/tools/trace_summary.py``; the padding is that of
``tools/timing.py::profiled_round``. torch.profiler keeps a kernel record
only if the kernel's device timestamps, converted to the host clock, fall
inside the session, and on an H100 that conversion is off by a different
amount in each session: so each round is padded with host idle at both
edges, a warm-up round comes first, and a session whose records are short
is taken again."""

from __future__ import annotations

import collections
import json
import os
import time

# host seconds left idle at each edge of a profiled round
PROFILE_EDGE_S = 0.05
# sessions taken before the stretch is given up as incomplete
ATTEMPTS = 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPAN_CATS = ("user_annotation",)


def load_trace_events(path: str) -> list:
    """All complete ('ph' == 'X') events of a chrome-trace file."""
    with open(path) as f:
        data = json.load(f)
    return [ev for ev in data.get("traceEvents", []) if ev.get("ph") == "X"]


def device_events(events) -> list:
    return [ev for ev in events if ev.get("cat") in DEVICE_CATS]


def exclusive_times(events):
    """Per-name exclusive (self) durations, µs, by containment per lane."""
    lanes = collections.defaultdict(list)
    for ev in events:
        lanes[(ev.get("pid"), ev.get("tid"))].append(ev)
    self_time = collections.Counter()
    counts = collections.Counter()
    for evs in lanes.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []
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


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(busy, spans, top: int = 10) -> list:
    """The device's idle gaps between the ``busy`` intervals (µs), summed
    by the innermost host span (name, start, end) open at each gap's
    start, longest first: [[name, seconds], ...]."""
    by = collections.Counter()
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = "<no host span>"
        for n, a, b in spans:
            if a <= e0 < b:
                name = n
        by[name] += s1 - e0
    return [[n, t / 1e6] for n, t in by.most_common(top)]


def summarize(events) -> dict:
    """The stretch's device figures from its trace events: kernel records
    by name (µs and count), the busy union, the window from the first
    device record's start to the last one's end, and the breakdown."""
    dev = device_events(events)
    if not dev:
        return {"kernels": 0}
    busy = union((ev["ts"], ev["ts"] + ev.get("dur", 0)) for ev in dev)
    kernels = [ev for ev in dev if ev.get("cat") == "kernel"]
    by_name = collections.Counter()
    n_name = collections.Counter()
    for ev in kernels:
        by_name[ev["name"]] += ev.get("dur", 0)
        n_name[ev["name"]] += 1
    self_time, _ = exclusive_times(dev)
    spans = [(ev["name"], ev["ts"], ev["ts"] + ev.get("dur", 0))
             for ev in events if ev.get("cat") in HOST_SPAN_CATS]
    return {
        "kernels": len(kernels),
        "kernel_us": by_name, "kernel_n": n_name,
        "kernel_busy_s": sum(ev.get("dur", 0) for ev in kernels) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (busy[-1][1] - busy[0][0]) / 1e6,
        "breakdown": {
            "device_ops": [[n, t / 1e6] for n, t in
                           self_time.most_common(10)],
            "idle_gaps": idle_gaps(busy, spans)},
    }


def profile(unit, path: str, complete) -> tuple[dict, object]:
    """Profile one call of ``unit`` (after a warm-up call in the same
    session), each padded by PROFILE_EDGE_S of host idle. ``complete(
    summary)`` says whether the session kept every record it should;
    incomplete sessions are taken again, up to ATTEMPTS. Returns the
    summary and what the recorded call of ``unit`` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_session
    from torch.profiler import record_function, schedule

    os.makedirs(os.path.dirname(path), exist_ok=True)
    summary = ran = None
    for _ in range(ATTEMPTS):
        with prof_session(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA],
                          schedule=schedule(wait=0, warmup=1, active=1),
                          on_trace_ready=lambda p: p.export_chrome_trace(
                              path)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_EDGE_S)
                with record_function("bench.unit"):
                    ran = unit()
                torch.cuda.synchronize()
                time.sleep(PROFILE_EDGE_S)
                prof.step()
        summary = summarize(load_trace_events(path))
        os.remove(path)
        if complete(summary):
            break
    return summary, ran

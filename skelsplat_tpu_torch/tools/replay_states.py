"""Where a chained sweep's slow state lies: each scene's device time and
each graph replay's, split by the scene's speed state.

Runs ``bench.py``'s chained sweep from a process's first frame: H36M
scenes of 500 iterations in groups of 32 through ``optimize_scene_chain``, two
groups in flight behind the one being enqueued, for ``--seconds``, with
the ``tracing`` module's detail level on (an event pair around every
graph replay). It writes the program trace (``tracing.export``) to
``--out`` and prints one JSON line that reduces it: every scene whose
device interval is longer than ``--slow-ms`` is in the slow state, the
others in the fast one, and each replay takes its scene's state (a
replay record's parent is its scene's ``skelsplat.launch`` span). For
each state and each program (``launch`` for the scenes themselves,
``prepare``, ``step``, ``collect``): the number of records, their device
ms (mean, min, max) and the device gap before each (µs: median, mean,
99th percentile), the time the device spent between the end of one
record of the kind and the start of the next. ``--bin-s`` adds a time
line: per bin of that many seconds, the step replays' mean device ms.

``--reduce TRACE`` reduces a trace written before (``.json`` or
``.json.gz``: this tool's, or ``bench.py --program-trace``'s) without
running anything.

Usage:
    python -m skelsplat_tpu_torch.tools.replay_states --out states.json
        [--seconds 70] [--detail 1] [--slow-ms 180] [--bin-s 10]
    python -m skelsplat_tpu_torch.tools.replay_states --reduce TRACE
        [--slow-ms 180] [--bin-s 10]

``--slow-ms 180`` splits these scenes, whose device interval reads about
167 ms in the fast state and 194 ms in the slow one on an H100; a trace of
another configuration needs its own split.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import statistics
import sys
import time

from skelsplat_tpu_torch.tracing import LAUNCH, REPLAY

GROUP = 32      # scenes a chained group, as bench.py's default


def load(path: str) -> list:
    """The device records (``cat`` "device") of a program trace."""
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "device"]


def _stats(values: list, scale: float = 1.0) -> dict:
    v = sorted(x * scale for x in values)
    if not v:
        return {}
    return {"mean": statistics.fmean(v), "median": statistics.median(v),
            "min": v[0], "max": v[-1], "p99": v[int(0.99 * (len(v) - 1))]}


def reduce(events: list, slow_ms: float, bin_s: float | None = None) -> dict:
    """Device records of a program trace by speed state and program:
    ``states[state][program]`` = {"n", "device_ms", "gap_us"} (the last
    two as ``_stats``); ``scenes`` the number of scenes in each state;
    with ``bin_s``, ``bins`` = [[seconds from the first record, step
    replays' mean device ms, their number], ...]."""
    state = {}
    for e in events:
        if e["name"] == LAUNCH:
            slow = e["args"]["device_ms"] > slow_ms
            state[e["args"]["id"]] = "slow" if slow else "fast"
    groups = collections.defaultdict(lambda: collections.defaultdict(list))
    for e in events:
        a = e["args"]
        if e["name"] == LAUNCH:
            s, program = state[a["id"]], "launch"
        elif e["name"].startswith(REPLAY):
            s, program = state.get(a["parent"]), e["name"][len(REPLAY):]
        else:
            continue
        if s is not None:
            groups[s][program].append((a["device_ms"], a["gap_ms"]))
    out = {"slow_ms": slow_ms,
           "scenes": {s: len(g["launch"]) for s, g in groups.items()},
           "states": {}}
    for s, programs in sorted(groups.items()):
        out["states"][s] = {
            p: {"n": len(v), "device_ms": _stats([d for d, _ in v]),
                "gap_us": _stats([g for _, g in v if g is not None], 1e3)}
            for p, v in sorted(programs.items())}
    if bin_s and events:
        first = min(e["ts"] for e in events)
        bins = collections.defaultdict(list)
        for e in events:
            if e["name"] == REPLAY + "step":
                bins[int((e["ts"] - first) / 1e6 // bin_s)].append(
                    e["args"]["device_ms"])
        out["bins"] = [[b * bin_s, statistics.fmean(v), len(v)]
                       for b, v in sorted(bins.items())]
    return out


def run(seconds: float, detail: bool, out: str) -> dict:
    """The chained sweep for ``seconds`` from this process's first frame;
    the program trace written to ``out``. Returns the groups' end times
    (seconds from the start) and the window's sums (``tracing.window``)."""
    from skelsplat_tpu_torch import tracing
    from skelsplat_tpu_torch.bench import _fetch, make_trainer
    from skelsplat_tpu_torch.graft_entry import _synthetic_inputs

    t_start = time.perf_counter()
    width, height = 1002, 1000
    init, gt, p2d, cams = _synthetic_inputs(2 * GROUP, width, height,
                                            n_joints=17, device="cpu")
    trainer = make_trainer("h36m", width, height, 500, "cuda")
    tracing.clear()
    tracing.enable(detail)
    pending, done, g = [], [], 0
    try:
        while time.perf_counter() - t_start < seconds:
            k = (g % 2) * GROUP
            job = trainer.optimize_scene_chain(
                [trainer.host_inputs(init[s], p2d[s], cams, gt[s])
                 for s in range(k, k + GROUP)], lean=True)
            pending.append((g, _fetch(job)))
            while len(pending) > 2:
                gg, fetch = pending.pop(0)
                fetch.result()
                done.append((gg, time.perf_counter() - t_start))
            g += 1
        for gg, fetch in pending:
            fetch.result()
            done.append((gg, time.perf_counter() - t_start))
    finally:
        tracing.enable(False)
    win = tracing.window(t_start, time.perf_counter())
    tracing.export(out)
    return {"groups": done, "counters": win["counters"],
            "scene_device_s": win["scene_device_s"],
            "graph_gap_s": win["graph_gap_s"], "scenes": win["scenes"],
            "replays": win["replays"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="program trace to write (run mode)")
    ap.add_argument("--reduce", metavar="TRACE",
                    help="reduce TRACE instead of running")
    ap.add_argument("--seconds", type=float, default=70.0)
    ap.add_argument("--detail", type=int, default=1,
                    help="1: an event pair around every graph replay")
    ap.add_argument("--slow-ms", type=float, default=180.0,
                    help="a scene's device ms above which it is slow")
    ap.add_argument("--bin-s", type=float, default=None,
                    help="seconds per bin of the step replays' time line")
    args = ap.parse_args(argv)
    if (args.out is None) == (args.reduce is None):
        ap.error("give exactly one of --out and --reduce")
    result = {}
    path = args.reduce
    if path is None:
        result["run"] = run(args.seconds, bool(args.detail), args.out)
        path = args.out
    result.update(reduce(load(path), args.slow_ms, args.bin_s))
    print(json.dumps(result), file=sys.stdout, flush=True)
    return result


if __name__ == "__main__":
    main()

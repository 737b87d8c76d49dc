"""Benchmark: per-frame multi-view optimization wall-clock on the card
(counterpart of the root ``bench.py``).

Runs the flagship H36M configuration (17 joints, 4 views at 1002×1000,
500 iterations = 125 macro steps, l2_gaussian + limb consistency, so
``renderer="auto"`` takes the hand-written kernel of
``csrc/raster_loss.cu``) on synthetic inputs and reports seconds per
frame. Prints ONE JSON line, last:

    {"metric": "h36m_frame_opt_seconds", "value": ..., "unit": "s/frame",
     "vs_baseline": ...}

    python -m skelsplat_tpu_torch.bench [--frames 64] [--iterations 500]
        [--small] [--preset h36m|h36m-occ|panoptic|op] [--batch B]
        [--group 32] [--sync-fetch] [--profile DIR] [--program-trace FILE]
        [--device cuda|cpu]

What it times, in order (stderr lines as the root bench prints them):

* **latency**: ``optimize_scene(lean=True)`` frame by frame, each timed
  through a host copy of ``params.xyz``; frame 0 (the kernel build and
  the program captures) is left out, the median is reported;
* **the chained sweep** (the headline): the frames in groups of
  ``--group`` through ``optimize_scene_chain``, each group's host inputs
  made inside the timed loop, the chain warmed first at every group size
  the loop uses (a group larger than any before it grows the shape's
  group buffers, and its prepare and collect are captured again). Each
  group's result copy (``driver._Fetch``:
  pinned, non-blocking, with an event) starts right after the group is
  enqueued; the host waits for group k after dispatching group k+2, as
  the root bench's fetch thread lets it, or, with ``--sync-fetch``,
  right after dispatching group k+1;
* **the batch** (``--batch B`` > 1): B scenes through
  ``optimize_scene_batch``, one warm call, then two batches in flight and
  both fetched. As in the root bench, the batch runs without dropout
  masks, and ``value`` is then the batch's s/frame, not the sweep's;
* **the profile** (``--profile DIR``): one frame under ``torch.profiler``
  (a warm-up round, then the recorded one), written to DIR as a chrome
  trace that ``tools/trace_summary.py`` reads. Unlike the root bench it
  runs after every timed run: after a profiler session in a process, a
  captured program's launch costs ~10× its host time, which would inflate
  the batch's number;
* **the program trace** (``--program-trace FILE``): the ``tracing``
  module's detail level on for the whole run (an event pair around every
  graph replay), and its records written to FILE at the end as one
  chrome trace (``tracing.export``): host spans, each scene's device
  interval and each replay's, on the host clock.

``h36m-occ`` draws one dropout mask per scene, in scene order, from a CPU
generator seeded 0: the root bench's draws from torch's global generator
after ``torch.manual_seed(0)``, the same sequence.

``vs_baseline`` is speedup vs REF_SECONDS_PER_FRAME, the root bench's
estimate of the reference CUDA pipeline on an A100, in its own words: "the
repo publishes no numbers (BASELINE.md), so we budget its 500 sequential
rasterizer forward+backward launches (tile binning + radix sort +
17-channel composite over ~1 Mpx, plus the python-side loss/optimizer
overhead per iteration) at 5 ms/iter → 2.5 s/frame. Replace with a
measured number when an A100 run exists." It is an estimate, not a
measurement.

It runs on the GPU unless ``--device cpu`` is given; asking for the GPU
on a host without one raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device, tracing
from skelsplat_tpu_torch.core.cameras import stack_cameras
from skelsplat_tpu_torch.core.gaussians import SkeletonModel
from skelsplat_tpu_torch.engine.driver import _Fetch
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
from skelsplat_tpu_torch.graft_entry import _synthetic_inputs
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.tools.timing import PROFILE_EDGE_S
from skelsplat_tpu_torch.utils import tree_leaves

REF_SECONDS_PER_FRAME = 2.5

PRESETS = {
    # (W, H, joints, scene_type, scaling_modifier, dropout): the root
    # bench's. Image sizes per dataset_readers.py; scaling_modifier per
    # configs/*.yaml (op and h36m-occ ship 1.25); dropout=True on h36m-occ
    # exercises the occlusion experiment's channel zeroing
    "h36m": (1002, 1000, 17, "h36m", 1.0, False),
    "h36m-occ": (1002, 1000, 17, "h36m", 1.25, True),
    "panoptic": (1920, 1080, 19, "panoptic", 1.0, False),
    "op": (1280, 720, 15, "occlusion-person", 1.25, False),
}
SMALL = (256, 256)
TRACE_FILE = "bench_trace.json"


def parser() -> argparse.ArgumentParser:
    """The root bench's options, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=64,
                    help="timed frames (after 1 build/capture warm-up "
                         "frame): two chained groups of 32 by default")
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--small", action="store_true",
                    help="256x256 debug size instead of the preset's")
    ap.add_argument("--preset", default="h36m",
                    choices=["h36m", "h36m-occ", "panoptic", "op"],
                    help="dataset scale: h36m 1002x1000x17, panoptic "
                         "1920x1080x19, op (occlusion-person) 1280x720x15, "
                         "h36m-occ = h36m frames with scaling_modifier "
                         "1.25 and per-scene dropout masks")
    ap.add_argument("--batch", type=int, default=0,
                    help="also measure same-device scene batching at this "
                         "batch size (throughput mode; value is then the "
                         "batch's s/frame)")
    ap.add_argument("--group", type=int, default=32,
                    help="scenes chained per optimize_scene_chain call in "
                         "the sweep (the driver's training.fetch_scenes)")
    ap.add_argument("--sync-fetch", action="store_true",
                    help="wait for group k's results right after group k+1 "
                         "is dispatched, instead of after group k+2")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler chrome trace of one frame "
                         "to DIR, after the timed runs")
    ap.add_argument("--program-trace", default=None, metavar="FILE",
                    help="record every graph replay's device interval "
                         "(the tracing module's detail level) and write "
                         "the program's records to FILE as a chrome trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap


def dropout_masks(n_scenes: int, n_views: int, n_joints: int) -> list:
    """The scenes' (V,N) bool dropout masks, drawn one scene at a time from
    a CPU generator seeded 0 (the root bench's ``torch.manual_seed(0)``
    then ``dropout_masks_torch`` per scene)."""
    gen = torch.Generator().manual_seed(0)
    return [hm.dropout_masks_torch(n_views, n_joints, gen)
            for _ in range(n_scenes)]


def make_trainer(preset: str, width: int, height: int, iterations: int,
                 device) -> SceneTrainer:
    """The preset's trainer at a ``width``×``height`` frame."""
    _, _, n_joints, scene_type, modifier, dropout = PRESETS[preset]
    model = SkeletonModel(scene_type, n_joints, scaling=3.0,
                          scaling_modifier=modifier)
    return SceneTrainer(model, OptConfig(iterations=iterations),
                        TrainSettings(dropout=dropout), width, height,
                        renderer="auto", device=device)


def _fetch(job) -> _Fetch:
    """Start one host copy of a result tree's tensors (``driver._Fetch``)."""
    return _Fetch(tree_leaves(job))


def _xyz(fetched) -> np.ndarray:
    """xyz of a fetched (params, history) tree: its first leaf."""
    xyz = fetched[0]
    assert np.isfinite(xyz).all()
    return xyz


def _profile(frame, out_dir: str, dev: torch.device) -> str:
    """A chrome trace of ``frame()`` (a warm-up round, then the recorded
    one, each padded by PROFILE_EDGE_S of host idle, as
    ``tools/timing.py::profiled_round`` pads its rounds: torch.profiler
    keeps a kernel record only if its converted device timestamps fall
    inside the session) in ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, TRACE_FILE)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_EDGE_S)
            frame()     # ends in a host copy, which waits for the device
            time.sleep(PROFILE_EDGE_S)
            prof.step()
    return path


def run(argv=None) -> dict:
    """Run the benchmark and return its results: ``frame_s`` (each timed
    frame's seconds), ``latency`` (their median), ``sweep`` (the chained
    sweep's s/frame), ``batch`` (the batch's s/frame, or None), ``value``
    (the reported one), ``sweep_xyz`` ((frames, N, 3): scenes 1.. of the
    sweep), ``batch_xyz`` ((2, B, N, 3) or None), ``trace`` (the profile's
    path or None), ``program_trace`` (the program trace's path or None)
    and ``record`` (the JSON line's object). Progress goes to stderr."""
    args = parser().parse_args(argv)
    if args.program_trace:
        tracing.clear()
        tracing.enable(detail=True)
    dev = resolve_device(args.device)
    W, H, n_joints, _, _, dropout = PRESETS[args.preset]
    if args.small:
        W, H = SMALL

    n = args.frames + 1
    # the cameras stay on the host, as the sweep driver keeps them: a
    # scene's extent then reads their centres without a device round trip
    init, gt, p2d, cams = _synthetic_inputs(n, W, H, n_joints=n_joints,
                                            device="cpu")
    trainer = make_trainer(args.preset, W, H, args.iterations, dev)
    nv = p2d.shape[1]
    dmasks = (dropout_masks(n, nv, n_joints) if dropout else [None] * n)

    def frame(s, drop_mask):
        params, _ = trainer.optimize_scene(init[s], p2d[s], cams, gt[s],
                                           lean=True, drop_mask=drop_mask)
        # through a host copy of the result, which waits for the device
        return params.xyz.cpu().numpy()

    times = []
    for s in range(n):
        t0 = time.perf_counter()
        xyz = frame(s, dmasks[s])
        dt = time.perf_counter() - t0
        assert np.isfinite(xyz).all()
        if s > 0:   # frame 0 pays the kernel build and the captures
            times.append(dt)
        print(f"frame {s}: {dt:.3f}s"
              + ("  (build+capture+run)" if s == 0 else ""), file=sys.stderr)
    latency = float(np.median(times))
    print(f"per-scene latency (dispatch→fetch): {latency:.4f} s/frame",
          file=sys.stderr)

    def host_inputs(s):
        return trainer.host_inputs(init[s], p2d[s], cams, gt[s],
                                   drop_mask=dmasks[s])

    # warm the chain's programs for every group size the loop uses
    group = args.group
    gsz = min(group, n - 1)
    tail = (n - 1) % group
    for sz in sorted({gsz} | ({tail} if tail else set())):
        warm = trainer.optimize_scene_chain(
            [host_inputs(1) for _ in range(sz)], lean=True)
    _xyz(_fetch(warm).result())

    max_pending = 1 if args.sync_fetch else 2
    t0 = time.perf_counter()
    fetched, pending = [], []
    for g0 in range(1, n, group):
        job = trainer.optimize_scene_chain(
            [host_inputs(s) for s in range(g0, min(g0 + group, n))],
            lean=True)
        pending.append(_fetch(job))
        while len(pending) > max_pending:
            fetched.append(_xyz(pending.pop(0).result()))
    fetched += [_xyz(f.result()) for f in pending]
    value = sweep = (time.perf_counter() - t0) / (n - 1)
    sweep_xyz = np.concatenate(fetched)
    print(f"pipelined sweep: {sweep:.4f} s/frame "
          f"({args.frames} frames in flight, chained groups of {group})",
          file=sys.stderr)

    batch = batch_xyz = None
    if args.batch > 1:
        B = args.batch
        initb, gtb, p2db, _ = _synthetic_inputs(B, W, H, n_joints=n_joints,
                                                device="cpu")
        cams_bb = stack_cameras([cams] * B)
        _xyz(_fetch(trainer.optimize_scene_batch(
            initb, p2db, cams_bb, gtb, lean=True)).result())
        t0 = time.perf_counter()
        jobs = [_fetch(trainer.optimize_scene_batch(initb, p2db, cams_bb,
                                                    gtb, lean=True))
                for _ in range(2)]
        batch_xyz = np.stack([_xyz(job.result()) for job in jobs])
        dt = time.perf_counter() - t0
        value = batch = dt / (2 * B)
        print(f"batch {B}: {dt:.3f}s for 2 pipelined batches, "
              f"{batch:.4f} s/frame", file=sys.stderr)

    program_trace = None
    if args.program_trace:
        tracing.enable(False)
        program_trace = tracing.export(args.program_trace)
        print(f"program trace written to {program_trace}", file=sys.stderr)

    trace = None
    if args.profile:
        trace = _profile(lambda: frame(1, None), args.profile, dev)
        print(f"trace written to {trace}", file=sys.stderr)

    record = {
        "metric": f"{args.preset}_frame_opt_seconds",
        "value": round(value, 4),
        "unit": "s/frame",
        "vs_baseline": round(REF_SECONDS_PER_FRAME / value, 3),
    }
    return {"frame_s": times, "latency": latency, "sweep": sweep,
            "batch": batch, "value": value, "sweep_xyz": sweep_xyz,
            "batch_xyz": batch_xyz, "trace": trace,
            "program_trace": program_trace, "record": record}


def main(argv=None) -> dict:
    """Run the benchmark and print its JSON line; returns ``run``'s
    results."""
    result = run(argv)
    print(json.dumps(result["record"]), flush=True)
    return result


if __name__ == "__main__":
    main()

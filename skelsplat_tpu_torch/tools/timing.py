"""Timing on the card, shared by the measurement tools and chip_smoke.py.

Every time these give belongs beside the card's name and power limit
(``card_line``): a card set below its power limit runs slower under load.
"""

from __future__ import annotations

import subprocess
import time

import torch

# Host seconds left idle at each edge of a profiled round. torch.profiler
# keeps a kernel record only if the kernel's device timestamps, converted to
# the host clock, fall inside the session's window, and on an H100 that
# conversion is off by a different amount in each session (chip_smoke.py's
# trace phase prints the spread): a round of a few milliseconds can lose its
# first records, or all of them.
PROFILE_EDGE_S = 0.05


def profiled_round(prof, fn, reps: int) -> None:
    """One round of ``reps`` calls of ``fn`` in the profiler session
    ``prof``, idle for PROFILE_EDGE_S before the calls and after they end
    on the device, then ``prof.step()``."""
    time.sleep(PROFILE_EDGE_S)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    time.sleep(PROFILE_EDGE_S)
    prof.step()


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3,
            each_kernel_once: bool = False) -> tuple[float, float]:
    """(device ms, stream ms) per call of ``fn``: the summed duration of the
    kernels it launches (torch.profiler kernel rows), and CUDA-event time
    over ``reps`` back-to-back calls, which includes any host time the
    device waits for (the wrapper's own Python overhead when a kernel is
    shorter).

    The profiler records one warm-up round of ``reps`` calls before the
    measured round, each round padded by ``profiled_round``: without the
    padding it lost kernel records at a round's edges on an H100 (4 of 10
    two-millisecond launches at the start of a session; 3 of 400 short
    launches, 1 of 10 two-millisecond ones in a warmed round). With
    ``each_kernel_once`` (``fn`` launches each of its kernels once per
    call, as a kernel wrapper does) the device time is the sum of each
    kernel's mean duration, and a kernel with under half its records
    raises; otherwise it is the round's summed kernel time over ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / reps
    rows = []

    def kernel_rows(p):    # the active round's rows, read before they clear
        rows.extend((e.device_time_total, e.count) for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA)

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=kernel_rows) as prof:
        for _ in range(2):
            profiled_round(prof, fn, reps)
    if not rows or sum(t for t, _ in rows) <= 0:
        raise RuntimeError("the profiler recorded no kernel time")
    if not each_kernel_once:
        return sum(t for t, _ in rows) / reps / 1e3, stream_ms
    for _, n in rows:
        if not reps / 2 <= n <= reps:
            raise RuntimeError(f"the profiler recorded {n} launches of a "
                               f"kernel launched once in each of {reps} calls")
    return sum(t / n for t, n in rows) / 1e3, stream_ms

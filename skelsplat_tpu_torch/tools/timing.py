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
# Profiler sessions ``cuda_ms`` takes before it gives up on one whose
# kernels all kept at least half their records.
PROFILE_ATTEMPTS = 5


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


def cuda_ms(fn, reps: int, warmup: int = 3, each_kernel_once: bool = False,
            per_kernel: dict | None = None) -> tuple[float, float]:
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
    kernel's mean duration; the session is taken again while a kernel has
    under half its records (the profiler on an H100 now and then still
    drops most of a round's records of one kernel: 7 of 200 in one
    session), and after PROFILE_ATTEMPTS sessions that raises. Otherwise
    it is the round's summed kernel time over ``reps``.
    A ``per_kernel`` dict is filled with each kernel's mean device ms per
    launch, by name."""
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

    def kernel_rows(p):    # the active round's rows, read before they clear
        rows.extend((e.key, e.device_time_total, e.count)
                    for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA)

    for _ in range(PROFILE_ATTEMPTS):
        rows = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=kernel_rows) as prof:
            for _ in range(2):
                profiled_round(prof, fn, reps)
        if not rows or sum(t for _, t, _ in rows) <= 0:
            error = "the profiler recorded no kernel time"
        elif each_kernel_once and any(not reps / 2 <= n <= reps
                                      for _, _, n in rows):
            error = (f"the profiler recorded {[n for _, _, n in rows]} "
                     f"launches of kernels launched once in each of {reps} "
                     f"calls")
        else:
            break
    else:
        raise RuntimeError(f"{error}, in each of {PROFILE_ATTEMPTS} sessions")
    if per_kernel is not None:
        per_kernel.update((k, t / n / 1e3) for k, t, n in rows)
    if not each_kernel_once:
        return sum(t for _, t, _ in rows) / reps / 1e3, stream_ms
    return sum(t / n for _, t, n in rows) / 1e3, stream_ms

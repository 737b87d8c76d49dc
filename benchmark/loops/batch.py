"""Traffic kind ``batch``: ``batch`` frames a call through
``SceneTrainer.optimize_scene_batch``, the batch's cameras stacked by
``stack_cameras``. Each batch's inputs are made just before its call; its
result copy starts right after the call returns, and with ``in_flight``
batches enqueued the host waits for the oldest. The loop sends batches
until the window's seconds have passed, then completes those in flight."""

from __future__ import annotations

import collections

import torch

from skbench import inputs
from skbench.program import Fetch, stacked_cameras
from skbench.window import Window, clock, start_window


def _enqueue(cell, stream, start, spans=None):
    B = cell.traffic["batch"]
    init, gt, p2d = cell.frames(stream, start, B)
    if getattr(cell, "_cams_b", None) is None:
        cell._cams_b = stacked_cameras(cell.cams, B)
    t0 = clock()
    with torch.profiler.record_function("bench.enqueue"):
        params, _ = cell.trainer.optimize_scene_batch(
            init, p2d, cell._cams_b, gt, lean=True)
    t1 = clock()
    if spans is not None:
        spans.append((t0, t1, B))
    return Fetch([params.xyz])


def warm(cell) -> None:
    """Two batches: the first captures the step, the second the batch's
    prepare."""
    B = cell.traffic["batch"]
    for k in range(2):
        _enqueue(cell, inputs.WARM, k * B).result()


def run(cell, seconds: float, spans: bool = False) -> Window:
    B, depth = cell.traffic["batch"], cell.traffic["in_flight"]
    w = start_window(spans)
    pending = collections.deque()
    sent = 0
    while clock() - w.start < seconds:
        pending.append((sent, _enqueue(cell, inputs.WINDOW, sent, w.spans)))
        sent += B
        if len(pending) >= depth:
            first, fetch = pending.popleft()
            w.complete(first, fetch.result()[0], fetch.event)
    while pending:
        first, fetch = pending.popleft()
        w.complete(first, fetch.result()[0], fetch.event)
    return w


def unit(cell):
    """A function that runs one batch to the host and returns its
    (stream, first frame, frames)."""
    B = cell.traffic["batch"]
    count = iter(range(2, 1 << 30))

    def one():
        start = next(count) * B
        _enqueue(cell, inputs.WARM, start).result()
        return inputs.WARM, start, B

    return one

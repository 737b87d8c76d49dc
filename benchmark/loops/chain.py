"""Traffic kind ``chain``: frames in chained groups of ``group`` through
``SceneTrainer.optimize_scene_chain``, as the sweep driver sends them.

Each group's host inputs are made just before its call, as a loader would;
its result copy starts right after the call returns, and with
``in_flight`` groups enqueued the host waits for the oldest. The loop
sends groups until the window's seconds have passed, then completes the
groups in flight."""

from __future__ import annotations

import collections

import torch

from skbench import inputs
from skbench.program import Fetch
from skbench.window import Window, clock, start_window


def _enqueue(cell, stream, start, n, spans=None):
    init, gt, p2d = cell.frames(stream, start, n)
    trainer = cell.trainer
    host = [trainer.host_inputs(init[k], p2d[k], cell.cams, gt[k])
            for k in range(n)]
    t0 = clock()
    with torch.profiler.record_function("bench.enqueue"):
        params, _ = trainer.optimize_scene_chain(host, lean=True)
    t1 = clock()
    if spans is not None:
        spans.append((t0, t1, n))
    return Fetch([params.xyz])


def warm(cell) -> None:
    """One group of the window's size: it captures the shape's step, its
    prepare and its collect, and sizes the group buffers."""
    _enqueue(cell, inputs.WARM, 0, cell.traffic["group"]).result()


def run(cell, seconds: float, spans: bool = False) -> Window:
    group, depth = cell.traffic["group"], cell.traffic["in_flight"]
    w = start_window(spans)
    pending = collections.deque()
    sent = 0
    while clock() - w.start < seconds:
        pending.append((sent, _enqueue(cell, inputs.WINDOW, sent, group,
                                       w.spans)))
        sent += group
        if len(pending) >= depth:
            first, fetch = pending.popleft()
            w.complete(first, fetch.result()[0], fetch.event)
    while pending:
        first, fetch = pending.popleft()
        w.complete(first, fetch.result()[0], fetch.event)
    return w


def unit(cell):
    """A function that runs one chained frame to the host and returns its
    (stream, first frame, frames): the traced stretch, short enough for
    the profiler to keep every record."""
    count = iter(range(cell.traffic["group"], 1 << 30))

    def one():
        start = next(count)
        _enqueue(cell, inputs.WARM, start, 1).result()
        return inputs.WARM, start, 1

    return one

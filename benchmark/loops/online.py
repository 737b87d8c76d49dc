"""Traffic kind ``online``: one caller sends one frame at a time through
``SceneTrainer.optimize_scene(lean=True)`` and waits for its pose on the
host (a copy of xyz) before it sends the next: a closed loop of one. A
frame's latency runs from its host inputs to its pose on the host."""

from __future__ import annotations

import torch

from skbench import inputs
from skbench.window import Window, clock, start_window


def _frame(cell, stream, index, spans=None):
    """(pose on the host, seconds from the call)."""
    init, gt, p2d = cell.frames(stream, index, 1)
    t0 = clock()
    with torch.profiler.record_function("bench.enqueue"):
        params, _ = cell.trainer.optimize_scene(
            init[0], p2d[0], cell.cams, gt[0], lean=True)
    t1 = clock()
    with torch.profiler.record_function("bench.fetch"):
        xyz = params.xyz.cpu().numpy()
    t2 = clock()
    if spans is not None:
        spans.append((t0, t1, 1))
    return xyz, t2 - t0


def warm(cell) -> None:
    """Two frames: the first captures the step, the second the prepare."""
    for k in range(2):
        _frame(cell, inputs.WARM, k)


def run(cell, seconds: float, spans: bool = False) -> Window:
    w = start_window(spans)
    sent = 0
    while clock() - w.start < seconds:
        xyz, dt = _frame(cell, inputs.WINDOW, sent, w.spans)
        w.complete(sent, xyz[None])
        w.latency_s.append(dt)
        sent += 1
    return w


def unit(cell):
    """A function that runs one frame to the host and returns its (stream,
    frame, 1)."""
    count = iter(range(2, 1 << 30))

    def one():
        start = next(count)
        _frame(cell, inputs.WARM, start)
        return inputs.WARM, start, 1

    return one

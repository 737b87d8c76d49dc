"""The measured window: what a traffic loop records, and the arithmetic on
it that end-to-end metrics and the run's earlier lines read."""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

clock = time.perf_counter


def start_window(spans: bool = False) -> "Window":
    """A window starting now, with a device mark where there is a GPU."""
    import torch

    mark = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
    return Window(start=clock(), mark=mark, spans=[] if spans else None)


@dataclasses.dataclass
class Window:
    """One run's window. ``done`` holds (time the unit completed, first
    frame, frames) per unit in order of completion;
    ``results`` first frame → the unit's poses (n,N,3); ``latency_s`` a per-frame wait where the loop times one;
    ``spans`` (start, end, frames) host spans around each enqueue call,
    kept only when a traced run asks for them. On a GPU ``mark`` is an
    event recorded at the start, and each unit's completion is also timed
    on the device, from ``mark`` to the event behind its result copy: the
    host sees a result only when it looks, which a loop that is blocked
    enqueueing does late."""

    start: float
    mark: object = None
    end: float | None = None
    done: list = dataclasses.field(default_factory=list)
    results: dict = dataclasses.field(default_factory=dict)
    latency_s: list = dataclasses.field(default_factory=list)
    spans: list | None = None

    def complete(self, first: int, xyz, event=None) -> None:
        """Unit ``first`` .. is on the host now; ``event`` was recorded
        behind its result copy."""
        t = clock()
        n = len(xyz)
        if event is not None and self.mark is not None:
            t_unit = self.start + self.mark.elapsed_time(event) / 1e3
        else:
            t_unit = t
        self.done.append((t_unit, first, n))
        self.results[first] = np.asarray(xyz)
        self.end = t

    @property
    def frames(self) -> int:
        return sum(n for _, _, n in self.done)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def units(self) -> list:
        """(first frame, frames) of every completed unit, in frame order."""
        return sorted((first, n) for _, first, n in self.done)

    def xyz(self) -> dict:
        """frame → (N,3) result of every completed frame."""
        return {first + k: xyz[k] for first, xyz in self.results.items()
                for k in range(len(xyz))}

    def quarters(self) -> tuple[float, float]:
        """s/frame of the units completed in the window's first quarter,
        and in its last: each unit's time from the completion before it
        (or the window's start) to its own, on the device's clock where
        there is one."""
        q = self.seconds / 4

        def rate(units, before):
            frames = sum(n for _, _, n in units)
            return (units[-1][0] - before) / frames if frames else math.nan

        first = [u for u in self.done if u[0] <= self.start + q] \
            or self.done[:1]
        last_at = next(i for i, u in enumerate(self.done)
                       if u[0] >= self.end - q)
        last_at = max(last_at, 1) if len(self.done) > 1 else 0
        before = self.done[last_at - 1][0] if last_at else self.start
        return rate(first, self.start), rate(self.done[last_at:], before)


def percentile(values, q: float) -> tuple[float, int]:
    """The nearest-rank ``q``-th percentile of ``values`` and how many
    values lie beyond it."""
    v = sorted(values)
    rank = max(math.ceil(q / 100 * len(v)), 1)
    return v[rank - 1], len(v) - rank

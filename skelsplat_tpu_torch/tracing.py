"""The port's own tracing: host spans, device intervals and counters of
the trainer's work (and the sweep driver's host syncs), recorded all the
time.

**Spans.** Each span records its name, its start and end on
``time.perf_counter_ns`` (the clock ``time.perf_counter`` reads), its own
id, its parent's id (the innermost span open when it started) and a unit
id: one unit per public call of the trainer, opened by its root span
(``skelsplat.scene``, ``skelsplat.chain`` or ``skelsplat.batch``); a
chain's scene also carries its index in the group. Spans go into a
bounded ring of ``RING`` records; ``window`` says when the ring has
dropped records of the interval it is asked about. While a
``torch.profiler`` session records, each span is also a
``record_function`` range of its name, so a trace puts the device's idle
gaps down to the program's spans; otherwise that costs one boolean test.

**Device intervals.** Each ``skelsplat.launch`` span (the host's launches
of one scene's programs, or of one batch's) takes a pair of CUDA events
from a pool: one recorded before the scene's first program, one after its
last. They are read without waiting (``Event.query``) at the next unit's
entry, or when the records are asked for: the scene's device time, and
the gap since the previous scene's end event, device time that no
program of the trainer's covered. Both are differences of two events, so
they keep the events' resolution (about half a microsecond); the
placement of an interval on the host clock goes through one anchor event
taken at read-out, and errs by up to some microseconds in a process that
ran for minutes (CUDA's float32 milliseconds).

**Counters**, incremented where the work happens: ``graph_launches`` by
program (prepare, step, collect), ``host_syncs`` by call site (every
synchronize, and every host copy of a device tensor, that the program
makes itself), ``captures`` by program, ``input_bytes`` (the packed
host inputs), and three of device work (``DEVICE``): ``kernel_launches``
by kernel label (``ops/_build.py::launch``), ``k1_run_length``, K1's
calls by run length, and ``k1_slot_bound``, K1's calls by the slot bound
of the tile-kernel build they launch ("16", "24" or "32"). A unit keeps
the counts made while it was open, so ``window`` counts what the units
of an interval did. A capture launches
nothing, so ``capturing`` holds back its device-work counts, and each
replay of the graph credits them (``Credit``, ``credit``).

**Detail** (off by default; ``enable(detail=True)``, ``enable(False)``):
one event pair around every graph replay, a ``skelsplat.replay.<program>``
record with its own device interval, and profiler ranges around the
sections of the eager macro step (``section``). Tracing never changes a
result: it records events and reads clocks, and touches no tensor.

The module keeps one thread's spans: the trainer and the driver run on
one thread in each process."""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _profiler

RING = 1 << 17
UNITS = ("skelsplat.scene", "skelsplat.chain", "skelsplat.batch")
LAUNCH = "skelsplat.launch"
REPLAY = "skelsplat.replay."
COUNTERS = ("graph_launches", "host_syncs", "captures", "input_bytes",
            "kernel_launches", "k1_run_length", "k1_slot_bound")
DEVICE = frozenset(("kernel_launches", "k1_run_length", "k1_slot_bound"))
CURRENT = -1    # a device interval on the current CUDA device

_now = time.perf_counter_ns
_NULL = contextlib.nullcontext()

counters = {name: collections.Counter() for name in COUNTERS}


class Record:
    """One span: ``t0``/``t1`` in ns of ``time.perf_counter_ns`` (``t1``
    None while open). A launch or replay record also holds its device
    interval once read: ``device_ms``, ``gap_ms`` (since the previous
    record of its kind ended on the device; None for the first) and
    ``at_ms`` (its device start after its device's origin event). A unit's
    root record holds the counts made inside it (``counts``; while it is
    open, replays' in ``credits``, Credit → replays)."""

    __slots__ = ("id", "name", "parent", "unit", "index", "t0", "t1",
                 "device", "events", "device_ms", "gap_ms", "at_ms",
                 "counts", "credits")

    def __init__(self, rid, name, parent, unit, index):
        self.id, self.name, self.parent = rid, name, parent
        self.unit, self.index = unit, index
        self.t0, self.t1 = _now(), None
        self.device = self.events = None
        self.device_ms = self.gap_ms = self.at_ms = None
        self.counts = self.credits = None

    @property
    def seconds(self) -> float | None:
        return None if self.t1 is None else (self.t1 - self.t0) / 1e9


class _Clock:
    """One device's event pool, its origin event (recorded before its first
    interval), the origin's time on the host clock (set at read-out) and
    the end event of the last read record of each kind."""

    def __init__(self, device: int):
        self.free = []
        self.origin = self.take()
        self.origin.record(torch.cuda.current_stream(device))
        self.host_ns = None
        self.last_end = {}

    def take(self):
        return self.free.pop() if self.free else torch.cuda.Event(
            enable_timing=True)


_ring: list = [None] * RING
_next_id = 0
_lost_until = -1    # the latest start of a record the ring dropped
_stack: list = []   # open records, innermost last
_unit: Record | None = None
_detail = False
_pending: collections.deque = collections.deque()
_clocks: dict = {}
_held: collections.Counter | None = None   # a capture's device-work counts


def clear(size: int = RING) -> None:
    """Drop every record and pending interval, zero the counters, and keep
    the next ``size`` records."""
    global _ring, _next_id, _lost_until, _unit
    _ring = [None] * size
    _next_id, _lost_until, _unit = 0, -1, None
    _stack.clear()
    _pending.clear()
    _clocks.clear()
    for c in counters.values():
        c.clear()


def enable(detail: bool = True) -> None:
    """Switch the detail level on (``enable(detail=True)``) or off
    (``enable(False)``); the always-on records do not depend on it."""
    global _detail
    _detail = bool(detail)


def _open(name: str, index=None) -> Record:
    global _next_id, _lost_until
    rid = _next_id
    _next_id += 1
    rec = Record(rid, name, _stack[-1].id if _stack else None,
                 None if _unit is None else _unit.id, index)
    at = rid % len(_ring)
    old = _ring[at]
    if old is not None and old.t0 > _lost_until:
        _lost_until = old.t0
    _ring[at] = rec
    _stack.append(rec)
    return rec


def _close(rec: Record) -> None:
    rec.t1 = _now()
    if _stack and _stack[-1] is rec:
        _stack.pop()
    elif rec in _stack:
        _stack.remove(rec)


class _Span:
    """``with span(...) as rec``: a record, and a profiler range of its
    name while a profiler session records."""

    __slots__ = ("name", "index", "rec", "rf")

    def __init__(self, name, index=None):
        self.name, self.index, self.rec, self.rf = name, index, None, None

    def __enter__(self) -> Record:
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _open(self.name, self.index)
        return self.rec

    def __exit__(self, *exc):
        _close(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Unit(_Span):
    """A public call's root span: it opens a unit unless one is open (a
    public call made inside another belongs to the outer one), and first
    reads the device intervals that have ended."""

    __slots__ = ("outer",)

    def __enter__(self) -> Record:
        global _unit
        if _pending:
            _read(wait=False)
        self.outer = _unit
        rec = super().__enter__()
        if self.outer is None:
            rec.unit = rec.id
            rec.counts = collections.Counter()
            rec.credits = collections.Counter()
            _unit = rec
        return rec

    def __exit__(self, *exc):
        global _unit
        rec = self.rec
        if self.outer is None:
            for credited, replays in rec.credits.items():
                for key, n in credited.counts.items():
                    rec.counts[key] += n * replays
            rec.credits = None
        _unit = self.outer
        return super().__exit__(*exc)


class _Timed(_Span):
    """A span with a device interval: an event recorded on CUDA device
    ``device``'s current stream as it opens, and one as it closes (the
    current device's when ``device`` is ``CURRENT``; no interval when it
    is None)."""

    __slots__ = ("device", "clock", "start")

    def __init__(self, name, device: int | None, index=None):
        super().__init__(name, index)
        self.device = device

    def __enter__(self) -> Record:
        rec = super().__enter__()
        if self.device == CURRENT:
            self.device = torch.cuda.current_device()
        if self.device is not None:
            rec.device = self.device
            self.clock = _clocks.get(self.device)
            if self.clock is None:
                self.clock = _clocks[self.device] = _Clock(self.device)
            self.start = self.clock.take()
            self.start.record(torch.cuda.current_stream(self.device))
        return rec

    def __exit__(self, *exc):
        if self.device is not None:
            end = self.clock.take()
            end.record(torch.cuda.current_stream(self.device))
            self.rec.events = (self.start, end)
            _pending.append(self.rec)
        return super().__exit__(*exc)


def span(name: str, index=None) -> _Span:
    """A span of ``name``: ``with tracing.span("skelsplat.load"): ...``."""
    return _Span(name, index)


def unit(name: str) -> _Unit:
    """The root span of a public call (one of ``UNITS``)."""
    return _Unit(name)


def launch(device: torch.device, index=None) -> _Timed:
    """The ``skelsplat.launch`` span of one scene (``index``: its place in
    a chain's group) or one batch, with a device interval on a GPU: on
    ``device``'s stream, or the current device's when it has no index."""
    cuda = None
    if device.type == "cuda":
        cuda = (torch.cuda.current_device() if device.index is None
                else device.index)
    return _Timed(LAUNCH, cuda, index)


def replay(program: str):
    """Detail: a ``skelsplat.replay.<program>`` record with a device
    interval around one graph replay (on the current device, where the
    replay runs); nothing when detail is off."""
    if not _detail:
        return _NULL
    return _Timed(REPLAY + program, CURRENT)


def profiler_range(name: str):
    """A profiler range of ``name`` while a profiler session records."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


def section(name: str):
    """Detail: a profiler range around a section of the eager macro
    step."""
    if _detail and _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


def count(counter: str, label: str, n: int = 1) -> None:
    """Add ``n`` to ``counters[counter][label]``, and to the open unit's;
    inside ``capturing``, a count of device work is held back instead."""
    if _held is not None and counter in DEVICE:
        _held[(counter, label)] += n
        return
    counters[counter][label] += n
    if _unit is not None:
        _unit.counts[(counter, label)] += n


@contextlib.contextmanager
def capturing(program: str):
    """``with capturing(program) as held``: around the capture of
    ``program``'s graph, the counts of device work go to ``held``, not to
    the counters; ``captures`` counts it if it ends cleanly."""
    global _held
    _held = held = collections.Counter()
    try:
        yield held
    finally:
        _held = None
    count("captures", program)


class Credit:
    """What one replay of ``program``'s graph counts (``counts``,
    (counter, label) → n): its launch and the ``held`` device work."""

    __slots__ = ("counts", "adds")

    def __init__(self, program: str, held):
        self.counts = {("graph_launches", program): 1, **held}
        self.adds = tuple((counters[c], label, n)
                          for (c, label), n in self.counts.items())


def credit(credited: Credit) -> None:
    """Add one replay's counts to the counters, and to the open unit's."""
    for counter, label, n in credited.adds:
        counter[label] += n
    if _unit is not None:
        _unit.credits[credited] += 1


def synced(site: str, tensor=None) -> None:
    """Count a host sync at ``site``: a synchronize, or (``tensor`` given)
    a host copy of ``tensor`` when it lies on a GPU."""
    if tensor is None or tensor.is_cuda:
        count("host_syncs", site)


# ---------------------------------------------------------------------------
# Read-out
# ---------------------------------------------------------------------------

def _read(wait: bool) -> None:
    """Read the pending device intervals in order, up to the first whose
    end has not happened (all of them with ``wait``: the caller has
    synchronized)."""
    while _pending:
        rec = _pending[0]
        start, end = rec.events
        if not wait and not end.query():
            return
        _pending.popleft()
        clock = _clocks[rec.device]
        kind = LAUNCH if rec.name == LAUNCH else REPLAY
        rec.device_ms = start.elapsed_time(end)
        rec.at_ms = clock.origin.elapsed_time(start)
        last = clock.last_end.get(kind)
        if last is not None:
            rec.gap_ms = last.elapsed_time(start)
            clock.free.append(last)
        clock.last_end[kind] = end
        clock.free.append(start)
        rec.events = None


def _anchor() -> None:
    """Synchronize every device that holds intervals, read what is
    pending, and put each device's origin event on the host clock: an
    event recorded on the idle device ran between the host times before
    its record and after its synchronize."""
    for dev, clock in _clocks.items():
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            mark = torch.cuda.Event(enable_timing=True)
            t0 = _now()
            mark.record()
            mark.synchronize()
            t1 = _now()
            clock.host_ns = (t0 + t1) / 2 - clock.origin.elapsed_time(
                mark) * 1e6
    _read(wait=True)


def records() -> list:
    """The records the ring holds, oldest first."""
    return sorted((r for r in _ring if r is not None), key=lambda r: r.id)


def _device_start_ns(rec: Record) -> float | None:
    if rec.at_ms is None:
        return None
    return _clocks[rec.device].host_ns + rec.at_ms * 1e6


def window(t0: float, t1: float) -> dict:
    """What the units whose root span lies inside [``t0``, ``t1``] (seconds
    of ``time.perf_counter``) did:

    * ``units``; ``wrapped``: the ring dropped records of the interval;
    * ``counters``: each counter's total, and ``by_label`` by label;
    * ``spans``: name → {"n", "s"}, the host seconds summed by name;
    * ``scene_device_s``: the summed device intervals of the launch spans,
      ``graph_gap_s`` the summed gaps before them (clipped at ``t0``),
      ``scenes`` their number; None where they have no device interval
      (no GPU);
    * ``replays`` (detail): program → {"n", "device_s", "gap_s"}.
    """
    lo, hi = int(t0 * 1e9), int(t1 * 1e9)
    if _clocks:
        _anchor()
    recs = records()
    units = {r.id for r in recs if r.unit == r.id and r.t1 is not None
             and r.t0 >= lo and r.t1 <= hi}
    out = {"units": len(units), "wrapped": _lost_until >= lo,
           "counters": dict.fromkeys(COUNTERS, 0),
           "by_label": {c: {} for c in COUNTERS}, "spans": {},
           "scene_device_s": None, "graph_gap_s": None, "scenes": 0,
           "replays": {}}
    timed = collections.defaultdict(list)
    for r in recs:
        if r.unit not in units or r.t1 is None:
            continue
        if r.counts:
            for (c, label), n in r.counts.items():
                out["counters"][c] += n
                out["by_label"][c][label] = out["by_label"][c].get(
                    label, 0) + n
        s = out["spans"].setdefault(r.name, {"n": 0, "s": 0.0})
        s["n"] += 1
        s["s"] += (r.t1 - r.t0) / 1e9
        if r.name == LAUNCH or r.name.startswith(REPLAY):
            timed[r.name].append(r)

    def summed(rs):
        if not rs or any(r.device_ms is None for r in rs):
            return None, None
        gap = 0.0
        for r in rs:
            before = (_device_start_ns(r) - lo) / 1e6
            gap += max(min(before if r.gap_ms is None else r.gap_ms,
                           before), 0.0)
        return sum(r.device_ms for r in rs) / 1e3, gap / 1e3

    launches = timed.pop(LAUNCH, [])
    out["scenes"] = len(launches)
    out["scene_device_s"], out["graph_gap_s"] = summed(launches)
    for name, rs in sorted(timed.items()):
        dev_s, gap_s = summed(rs)
        out["replays"][name[len(REPLAY):]] = {"n": len(rs), "device_s": dev_s,
                                             "gap_s": gap_s}
    return out


def export(path: str) -> str:
    """Write the ring's records as one chrome-trace JSON (Perfetto opens
    it): host spans on the ``host`` lane and device intervals on one lane
    per device and kind, on the host clock in µs, each with its ids, its
    device ms and its gap; the counters under ``otherData``."""
    if _clocks:
        _anchor()
    pid = os.getpid()
    events = [{"ph": "M", "name": "process_name", "pid": pid,
               "args": {"name": "skelsplat"}}]
    for r in records():
        if r.t1 is None:
            continue
        args = {"id": r.id, "parent": r.parent, "unit": r.unit}
        if r.index is not None:
            args["index"] = r.index
        events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid,
                       "tid": "host", "ts": r.t0 / 1e3,
                       "dur": (r.t1 - r.t0) / 1e3, "args": args})
        if r.device_ms is not None:
            kind = "launch" if r.name == LAUNCH else "replay"
            events.append({
                "ph": "X", "cat": "device", "name": r.name, "pid": pid,
                "tid": f"cuda:{r.device} {kind}",
                "ts": _device_start_ns(r) / 1e3, "dur": r.device_ms * 1e3,
                "args": dict(args, device_ms=r.device_ms, gap_ms=r.gap_ms)})
    other = {c: dict(v) for c, v in counters.items()}
    other["wrapped"] = _lost_until >= 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": other}, f)
    return path

"""What the program's own tracing (``skelsplat_tpu_torch/tracing.py``)
recorded inside a run's window, for the per-layer readers that read it.

The program keeps its spans, device intervals and counters all the time,
so the window's figures exist in every run; a traced run reads them. A
program without that module (an older checkout) gives nothing to read."""

from __future__ import annotations


def window(record) -> dict | None:
    """``tracing.window`` over the run's window, once per record; None
    where the program has no tracing, the window holds no frame or no
    unit of the program, or the program's ring dropped records of it."""
    if "program_trace" not in record:
        record["program_trace"] = _read(record["window"])
    return record["program_trace"]


def _read(w) -> dict | None:
    try:
        from skelsplat_tpu_torch import tracing
    except ImportError:
        return None
    if not w.frames or w.end is None:
        return None
    win = tracing.window(w.start, w.end)
    if win["wrapped"] or not win["units"]:
        return None
    return win


def per_frame_ms(record, seconds) -> float | None:
    """``seconds`` of the window's figures (None where absent), in ms a
    frame of the window."""
    if seconds is None:
        return None
    return seconds / record["window"].frames * 1e3

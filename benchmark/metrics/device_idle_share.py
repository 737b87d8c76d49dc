"""1 − the union of the device's kernel, copy and set intervals over the
traced unit's device window (first record's start to last record's end;
the profiler's padding lies outside it). It is read only where the
trace does not make the gaps it would measure: a unit of long kernels,
as a large batch's K1. Where a captured graph's ~150,000 short nodes
are each traced, the tracing's own gap between them reads as idle."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["summary"].get("kernels"):
        return None
    s = tr["summary"]
    return 1.0 - s["busy_s"] / s["window_s"]

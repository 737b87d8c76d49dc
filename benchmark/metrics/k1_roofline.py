"""K1's share of its roofline, %: the least time the card could take for
a call (the larger of the operations the inputs need over 67e12/s and the
bytes over 3.35e12 B/s, ``skbench/k1work.py``) over the measured mean time
of a call in the traced unit, both of K1's kernels (``KERNELS``)."""

from skbench.k1work import KERNELS


def read(record):
    tr = record["trace"]
    if not tr or not tr["complete"] or not tr["k1_calls"]:
        return None
    us = tr["summary"]["kernel_us"]
    k1_us = sum(t for name, t in us.items()
                if any(k in name for k in KERNELS))
    if k1_us <= 0:
        return None
    return tr["k1_bound_ms"] / (k1_us / 1e3 / tr["k1_calls"]) * 100

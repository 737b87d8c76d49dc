"""K1's kernel time (both kernels, ``KERNELS``) over all kernel time in
the traced unit."""

from skbench.k1work import KERNELS


def read(record):
    tr = record["trace"]
    if not tr or not tr["complete"] or not tr["k1_calls"]:
        return None
    us = tr["summary"]["kernel_us"]
    total = sum(us.values())
    k1_us = sum(t for name, t in us.items()
                if any(k in name for k in KERNELS))
    return k1_us / total if total > 0 and k1_us > 0 else None

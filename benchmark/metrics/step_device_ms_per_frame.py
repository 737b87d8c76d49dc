"""Summed device kernel time of the traced unit, per frame it ran, ms."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["complete"] or not tr["summary"].get("kernels"):
        return None
    return tr["summary"]["kernel_busy_s"] / tr["frames"] * 1e3

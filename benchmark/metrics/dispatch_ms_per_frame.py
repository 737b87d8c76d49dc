"""Host milliseconds a frame spends inside the program's enqueue call
(``optimize_scene_chain``, ``optimize_scene_batch`` or ``optimize_scene``,
from call to return, no synchronize), summed over the traced run's window
and divided by its frames."""


def read(record):
    w = record["window"]
    if not w.spans:
        return None
    return sum(b - a for a, b, _ in w.spans) / w.frames * 1e3

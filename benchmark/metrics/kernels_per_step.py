"""Device kernel records of the traced unit over its macro steps (a
batch's step counts once): the captured step's kernels, the prepare's and
the collect's spread over the steps. The count repeats exactly where the
profiler kept every record."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["complete"] or not tr["summary"].get("kernels"):
        return None
    return tr["summary"]["kernels"] / tr["steps"]

"""Seconds from the first line of run.py to the window's start: imports,
the kernel library, the CUDA context, the trainer, the inputs, the
captures and the loop's warm units."""


def read(record):
    return record["setup_s"]

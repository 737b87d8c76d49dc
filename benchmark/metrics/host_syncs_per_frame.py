"""Host syncs a frame that the program makes itself inside its public
calls (synchronizes and host copies of device tensors, the program's
``host_syncs`` counter) over the window's units, divided by its frames.
The benchmark's own result copies are not the program's and not
counted."""

from skbench import program_trace


def read(record):
    win = program_trace.window(record)
    if win is None:
        return None
    return win["counters"]["host_syncs"] / record["window"].frames

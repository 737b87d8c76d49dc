"""Device milliseconds a frame that no program of the trainer's covered:
for each scene (or batch) of the window's units, the time from the
previous one's end event to its own start event (from the window's start
for the first), by the program's CUDA events, divided by the window's
frames. It holds the input and result copies and the device's idle
between scenes. None without a GPU."""

from skbench import program_trace


def read(record):
    win = program_trace.window(record)
    return None if win is None else program_trace.per_frame_ms(
        record, win["graph_gap_s"])

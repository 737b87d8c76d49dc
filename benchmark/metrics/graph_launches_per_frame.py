"""CUDA graph launches a frame: the program's ``graph_launches`` counter
(prepare, step and collect replays) over the window's units, divided by
its frames. A chained frame is 127, a single frame 126 and a batch 126
over its frames."""

from skbench import program_trace


def read(record):
    win = program_trace.window(record)
    if win is None:
        return None
    return win["counters"]["graph_launches"] / record["window"].frames

"""Device milliseconds a frame inside the trainer's programs: each
``skelsplat.launch`` span's pair of CUDA events, one before a scene's (or
a batch's) first program and one after its last, summed over the
window's units and divided by its frames. Taken by the program in every
run, without a profiler. None without a GPU."""

from skbench import program_trace


def read(record):
    win = program_trace.window(record)
    return None if win is None else program_trace.per_frame_ms(
        record, win["scene_device_s"])

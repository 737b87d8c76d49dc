"""Host milliseconds a frame inside the program's ``skelsplat.launch``
spans: the host's launches of each scene's prepare, its 125 step replays
and its collect (one span per batch for a batch), summed over the
window's units and divided by its frames. The part of
``dispatch_ms_per_frame`` spent launching graphs."""

from skbench import program_trace


def read(record):
    win = program_trace.window(record)
    if win is None:
        return None
    return program_trace.per_frame_ms(
        record, win["spans"].get("skelsplat.launch", {}).get("s"))

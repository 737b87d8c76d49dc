"""The slot bound of the tile-kernel build that K1's calls launched (16,
24 or 32, from the joint count), averaged over the window's K1 calls:
the program's ``k1_slot_bound`` counter, by label, over the window's
units. It names the build of ``raster_loss_live`` that a cell times. A
program without the counter gives nothing to read."""

from skbench import program_trace


def read(record):
    win = program_trace.window(record)
    if win is None:
        return None
    by_bound = win["by_label"].get("k1_slot_bound")
    calls = sum(by_bound.values()) if by_bound else 0
    if not calls:
        return None
    return sum(int(bound) * n for bound, n in by_bound.items()) / calls

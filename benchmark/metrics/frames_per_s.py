"""Frames whose pose reached the host, over the whole window: from its
start to the moment the last pose was on the host."""


def read(record):
    w = record["window"]
    return w.frames / w.seconds

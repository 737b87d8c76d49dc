"""Median wait of a frame, from its host inputs to its pose on the host,
over every frame of the window (a loop that times each frame)."""

from skbench.window import percentile


def read(record):
    lat = record["window"].latency_s
    return percentile(lat, 50)[0] * 1e3 if lat else None

"""95th percentile (nearest rank) of a frame's wait, from its host inputs
to its pose on the host, over every frame of the window."""

from skbench.window import percentile


def read(record):
    lat = record["window"].latency_s
    return percentile(lat, 95)[0] * 1e3 if lat else None

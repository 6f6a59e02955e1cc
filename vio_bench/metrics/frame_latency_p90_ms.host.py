"""90th percentile (ms) of the frame latencies of the traced run's
window before the traced stretch: from a frame's first push to the end
of the `get_result` that returns its pose."""

import numpy as np

from vio_bench import layers


def read(res):
    _, frames = layers.untraced(res)
    lat = [res["latency_ms"][w] for w in frames]
    return float(np.percentile(lat, 90)) if lat else None

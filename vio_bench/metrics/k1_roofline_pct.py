"""K1's share (%) of its roofline in the traced stretch: the least time
of its calls (`roofline.k1_counts`) over its kernel's device time."""

from vio_bench import layers


def read(res):
    tr = res.get("trace")
    if tr is None:
        return None
    return layers.share_pct(layers.k1_least(res)[0], tr.device_seconds([res["K1_KERNEL"]]))

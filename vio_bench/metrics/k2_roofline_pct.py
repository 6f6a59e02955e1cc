"""K2's share (%) of its roofline in the traced stretch: the least time
of its calls (`roofline.k2_counts`; a call's two launches count as one)
over its kernels' device time."""

from vio_bench import layers


def read(res):
    tr = res.get("trace")
    if tr is None:
        return None
    return layers.share_pct(layers.k2_least(res)[0], tr.device_seconds(res["K2_KERNELS"]))

"""Mean host latency (ms) of the window's camera-rate PnP frames before
the traced stretch: the frames that ran the visual PnP
(`visual_pnp_time`) and no backend step (`backend_time`), from the
frame's first push to the end of the `get_result` that returns its
pose. This is the pose a user sees on the frames the backend skips."""

from vio_bench import layers


def read(res):
    spans, frames = layers.untraced(res)
    pnp = {f for n, f, _, _ in spans if n == "visual_pnp_time"}
    backend = {f for n, f, _, _ in spans if n == "backend_time"}
    lat = [res["latency_ms"][w] for w in frames if w in pnp and w not in backend]
    return sum(lat) / len(lat) if lat else None

"""Mean host time (ms) of the camera-rate visual PnP (`visual_pnp_time`)
per frame of the window."""

from vio_bench import layers


def read(res):
    spans, frames = layers.untraced(res)
    if not frames or not layers.count(spans, "visual_pnp_time"):
        return None
    return layers.stage_ms(spans, {"visual_pnp_time"}) / len(frames)

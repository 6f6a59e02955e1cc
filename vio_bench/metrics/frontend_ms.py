"""Mean host time (ms) of the frontend (the tracker's stage timer,
`feature_tracker_time`) per frame of the window."""

from vio_bench import layers


def read(res):
    spans, frames = layers.untraced(res)
    return layers.stage_ms(spans, {"feature_tracker_time"}) / len(frames) if frames else None

"""Mean host time (ms) of a keyframe's marginalization
(`bundle_adjustor_marginalization_time`) in the window."""

from vio_bench import layers

STAGE = "bundle_adjustor_marginalization_time"


def read(res):
    spans, _ = layers.untraced(res)
    n = layers.count(spans, STAGE)
    return layers.stage_ms(spans, {STAGE}) / n if n else None

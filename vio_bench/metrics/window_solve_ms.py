"""Host time (ms) of the window solves (`subwindow_solve_time` and
`bundle_adjustor_solve_time`) per backend frame of the window."""

from vio_bench import layers


def read(res):
    spans, _ = layers.untraced(res)
    n = layers.count(spans, "backend_time")
    return layers.stage_ms(spans, {"subwindow_solve_time", "bundle_adjustor_solve_time"}) \
        / n if n else None

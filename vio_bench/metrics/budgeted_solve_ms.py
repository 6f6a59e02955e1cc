"""Host time (ms) of the window solves (`subwindow_solve_time` and
`bundle_adjustor_solve_time`) per backend frame of the window, in the
cells whose configuration holds its solves to `solver_time_limit`: read
against the limit (100 ms in `iphone`)."""

from vio_bench import layers


def read(res):
    spans, _ = layers.untraced(res)
    names = {"subwindow_solve_time", "bundle_adjustor_solve_time"}
    n = layers.count(spans, "backend_time")
    if not n or not any(s[0] in names for s in spans):
        return None
    return layers.stage_ms(spans, names) / n

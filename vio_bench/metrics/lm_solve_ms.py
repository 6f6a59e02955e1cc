"""Host time (ms) of the LM loops (the solver's `lm_solve` stage) per
backend frame of the window: the part of `window_solve_ms` the loop
itself takes, the rest being the backend's own host work around it."""

from vio_bench import layers


def read(res):
    spans, _ = layers.untraced(res)
    n = layers.count(spans, "backend_time")
    if not n or not layers.count(spans, "lm_solve"):
        return None
    return layers.stage_ms(spans, {"lm_solve"}) / n

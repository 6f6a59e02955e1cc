"""Host time (ms) of the keymap refresh (`pnp_keymap_time`: the host
loop that mirrors the backend's landmarks into the camera-rate PnP's
table after each backend refresh) per backend frame of the window."""

from vio_bench import layers


def read(res):
    spans, _ = layers.untraced(res)
    n = layers.count(spans, "backend_time")
    if not n or not layers.count(spans, "pnp_keymap_time"):
        return None
    return layers.stage_ms(spans, {"pnp_keymap_time"}) / n

"""Share (%) of the traced stretch in which no operation runs on the
device."""


def read(res):
    tr = res.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)

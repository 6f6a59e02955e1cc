"""Device kernel launches per frame of the traced stretch, copies and
fills not counted."""


def read(res):
    tr = res.get("trace")
    if tr is None:
        return None
    lo, hi = res["trace_frames"]
    return len(tr.kernels()) / (hi - lo + 1)

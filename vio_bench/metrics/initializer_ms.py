"""Host time (ms) of an initialization attempt during set-up: the
`initializer_time` spans of the set-up frames over their
`initializer_attempts`."""

from vio_bench import record


def read(res):
    fr = record.setup_frames(res)
    if not fr:
        return None
    n = record.counter(res, fr, "initializer_attempts")
    ids = {s["frame"] for s in fr}
    ns = sum(s["end_ns"] - s["start_ns"] for s in res["record"]["spans"]
             if s["name"] == "initializer_time" and s["frame"] in ids)
    return ns * 1e-6 / n if n else None

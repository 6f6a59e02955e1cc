"""Mean host time (ms) of a keyframe frame (the program's `frame` span,
tagged `kind` keyframe) in the window before the traced stretch."""

from vio_bench import record


def read(res):
    fr = record.untraced_frames(res)
    kf = [s for s in fr or () if s["tags"].get("kind") == "keyframe"]
    if not kf:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in kf) * 1e-6 / len(kf)

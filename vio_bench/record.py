"""What the readers of the program's own trace record share
(`xrslam_tpu_torch/utils/timing.StageTimes`): the LM loop's spans
(`lm_solve`) laid over the traced stretch's device trace, and the
record's frames, counted in the order the run drove them.

`lm_solve` is one of the program's stages, so the stage tap
(`taps.Spans`, `res["spans"]`) sees it in every traced run. The rest of
the record (frame spans with their `kind`, the counters) is in
`res["record"]` (`StageTimes.export()`, times in Unix ns) only where
the run turned the record on; a reader that needs it returns None
without it. A kernel belongs to the span in which its device start
falls: the stretch's trace keeps device operations only, not their
launches."""

from __future__ import annotations

import bisect


def tap_lm_spans(res) -> list:
    """(start, end) of the `lm_solve` stage spans of the traced
    stretch's frames, on the trace's clock."""
    lo, hi = res["trace_frames"]
    off = res["off_ns"]
    return [(s + off, e + off) for n, f, s, e in res["spans"]
            if n == "lm_solve" and f is not None and lo <= f <= hi]


def kernels_in(tr, spans) -> list:
    """The trace's kernels (name, start, end) whose device start falls
    inside one of `spans` ((start, end) pairs on the trace's clock)."""
    ks = tr.kernels()
    starts = [k[1] for k in ks]
    out = []
    for s, e in spans:
        out += ks[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
    return out


def frames(res):
    """The record's `frame` spans in the order the run drove them, or
    None where the run kept no record."""
    rec = res.get("record")
    if rec is None:
        return None
    return sorted((s for s in rec["spans"] if s["name"] == "frame"),
                  key=lambda s: s["start_ns"])


def setup_frames(res):
    """The `frame` spans of set-up (the run's first `frame0` frames)."""
    fr = frames(res)
    return None if fr is None else fr[:res["frame0"]]


def untraced_frames(res):
    """The `frame` spans of the window before the traced stretch, as
    `layers.untraced` takes the stage spans."""
    fr = frames(res)
    if fr is None:
        return None
    lo, _ = res["trace_frames"]
    return fr[res["frame0"]:res["frame0"] + min(lo, res["frames"])]


def counter(res, frame_spans, name: str) -> int:
    """Sum of counter `name` over the frames of `frame_spans`."""
    per = res["record"]["frames"]
    return sum(per.get(s["frame"], {}).get(name, 0) for s in frame_spans)

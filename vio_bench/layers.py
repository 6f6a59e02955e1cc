"""What the per-layer readers (`metrics/<name>.py`) share: the stage
spans of the window outside the traced stretch, and the rooflines of
the traced stretch. A reader takes the run's record (`run.run_cell`'s
result) and returns a number, or None where it finds nothing to read."""

from __future__ import annotations

from . import roofline


def untraced(res: dict):
    """(spans, frames) of the window before the traced stretch: the
    profiler lengthens the frames it traces and, on the card, every
    frame after them too."""
    lo, _ = res["trace_frames"]
    spans = [s for s in res["spans"] if s[1] is not None and s[1] < lo]
    return spans, list(range(min(lo, res["frames"])))


def stage_ms(spans, names) -> float:
    return sum(e - s for n, _, s, e in spans if n in names) * 1e-6


def count(spans, name: str) -> int:
    return sum(1 for s in spans if s[0] == name)


def k1_least(res: dict):
    """(seconds, bound) summed over the stretch's K1 calls."""
    tot, kinds = 0.0, set()
    for c in res["k1_calls"]:
        n_bytes, flops = roofline.k1_counts([lv[-2:] for lv in c["levels"]], c["slots"],
                                            c["win"])
        t, kind = roofline.least_seconds(n_bytes, flops, 4)
        tot += t
        kinds.add(kind)
    return tot, "/".join(sorted(kinds))


def k2_least(res: dict):
    tot, kinds = 0.0, set()
    for c in res["k2_calls"]:
        n_bytes, flops = roofline.k2_counts(c["K"], c["L"], c["itemsize"], c["N"])
        t, kind = roofline.least_seconds(n_bytes, flops, c["itemsize"])
        tot += t
        kinds.add(kind)
    return tot, "/".join(sorted(kinds))


def share_pct(least_s: float, device_s: float):
    return 100.0 * least_s / device_s if least_s > 0 and device_s > 0 else None

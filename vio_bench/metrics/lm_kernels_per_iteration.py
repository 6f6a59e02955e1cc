"""Kernels launched inside the LM loops (`lm_solve` spans of the
program's record) of the traced stretch, per LM iteration
(`lm_iterations`) of those loops."""

from vio_bench import record


def read(res):
    tr, rec = res.get("trace"), res.get("record")
    if tr is None or rec is None:
        return None
    lm = [s for s in rec["spans"] if s["name"] == "lm_solve"
          and tr.start_ns <= s["start_ns"] and s["end_ns"] <= tr.end_ns]
    iters = sum(s["counters"].get("lm_iterations", 0) for s in lm)
    if not iters:
        return None
    return len(record.kernels_in(tr, [(s["start_ns"], s["end_ns"]) for s in lm])) / iters

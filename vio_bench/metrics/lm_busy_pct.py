"""Share (%) of the LM loops' host time (`lm_solve` spans of the traced
stretch) in which the kernels they launched run on the device."""

from vio_bench import record
from vio_bench.trace import Trace


def read(res):
    tr = res.get("trace")
    if tr is None:
        return None
    spans = record.tap_lm_spans(res)
    span_ns = sum(e - s for s, e in spans)
    if span_ns <= 0:
        return None
    ks = sorted(record.kernels_in(tr, spans), key=lambda k: k[1])
    busy_s = Trace(ops=ks, start_ns=tr.start_ns, end_ns=tr.end_ns).busy_s()
    return 100.0 * busy_s * 1e9 / span_ns

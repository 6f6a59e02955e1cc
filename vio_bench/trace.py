"""Reduction of the device trace of the traced stretch (`torch.profiler`
with CUDA activity only): the kernels with their times, the busy time
as the union of every device operation's interval, the idle gaps, and
the host stage that was open at each gap."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

K1_KERNEL = "klt_track_kernel"
K2_KERNELS = ("gram_main_kernel", "gram_reduce_kernel")
NAME_CHARS = 160   # the length to which the breakdown cuts an operation's name


@dataclass
class Trace:
    """Device operations of one traced stretch, times in ns on the
    profiler's clock (the wall clock)."""

    ops: List[Tuple[str, int, int]] = field(default_factory=list)   # name, start, end
    start_ns: int = 0
    end_ns: int = 0

    @staticmethod
    def from_profile(prof, start_ns: int, end_ns: int) -> "Trace":
        from torch.autograd import DeviceType

        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        ops.sort(key=lambda o: o[1])
        return Trace(ops=ops, start_ns=start_ns, end_ns=end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def kernels(self):
        """Kernel launches: every device operation but copies and fills."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, None
        for _, s, e in self.ops:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def gaps(self):
        """Idle intervals (start, end) inside the stretch."""
        out, cur = [], self.start_ns
        for _, s, e in self.ops:
            if s > cur:
                out.append((cur, min(s, self.end_ns)))
            cur = max(cur, e)
        if cur < self.end_ns:
            out.append((cur, self.end_ns))
        return [g for g in out if g[1] > g[0]]

    def device_seconds(self, names) -> float:
        """Total device seconds of the kernels whose names contain one
        of `names`."""
        return sum(e - s for n, s, e in self.kernels() if any(k in n for k in names)) * 1e-9

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the `n` operations that took most time."""
        tot = {}
        for name, s, e in self.ops:
            name = name[:NAME_CHARS]
            tot[name] = tot.get(name, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, offset_ns: int, n: int = 10):
        """[[host stage, seconds]] of the `n` longest idle gaps, each
        named by the innermost host span open at its middle (`spans`:
        (name, frame, start, end) on perf_counter_ns; `offset_ns` maps
        that clock onto the profiler's)."""
        out = []
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) // 2 - offset_ns
            open_ = [sp for sp in spans if sp[2] <= mid <= sp[3]]
            name = min(open_, key=lambda sp: sp[3] - sp[2])[0] if open_ else "host, no stage"
            out.append([name, (e - s) * 1e-9])
        return out

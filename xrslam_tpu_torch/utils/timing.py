"""Per-stage wall-clock timers, averaged per stage name.

Counterpart of `xrslam_tpu/utils/timing.py` without the inspection
slots. The timers read the host clock: CUDA work is asynchronous, so a
stage's time includes whatever device work its host syncs wait for."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class StageTimes:
    """Running averages of named stage times."""

    def __init__(self):
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._total[name] = self._total.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        return dict(self._total)

    def means(self) -> Dict[str, float]:
        return {k: self._total[k] / self._count[k] for k in self._total}


def mean_ms(fn, reps: int, device) -> float:
    """Milliseconds per call of fn() over `reps` calls after one untimed
    call, on the host clock ending in a device sync on a CUDA device."""
    import torch

    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps * 1e3

"""Per-stage wall-clock timers, averaged per stage name, and the port's
trace record.

Counterpart of `xrslam_tpu/utils/timing.py` without the inspection
slots. The timers read the host clock: CUDA work is asynchronous, so a
stage's time includes whatever device work its host syncs wait for.

The record (off by default; `StageTimes.record(True)` turns it on,
`export()` returns it) keeps every span and counter of the frames in
memory:

- spans: `frame` (`StageTimes.frame`, one a processed frame, with the
  program's frame id and a `kind` tag: init, track, subframe or
  keyframe, and a `pnp` tag on the frames that run the camera-rate
  PnP: published or skipped), every stage (`StageTimes.stage`) as a
  child of the span open around it, and `lm_solve` (the solver's LM
  loop);
- counters, per frame and per innermost open span: `lm_iterations`,
  `initializer_attempts`, `pnp_published`, `pnp_skipped`,
  `budget_clamped` (a solve that `solver_time_limit` cut), and
  `host_syncs`, each wait of the host on the device counted once: the
  explicit waits at their call site (`host_wait`), every other
  synchronizing operation through CUDA's sync-debug mode, whose
  warnings the record routes into the counter while it is on;
  `imu_samples_replayed` (the samples a pose's IMU propagation walks)
  goes to the newest frame processed, since the poses published
  between frames are propagated outside any frame.

Deep code without a `StageTimes` of its own (the solver, `utils/fetch`)
reaches the record of the frame being processed through `active()` and
`host_wait()`. Spans are stamped with `time.perf_counter_ns` and
exported in Unix ns, the clock `torch.profiler` gives its device
events, so they lay over a device trace. With the record off a span or
counter costs one attribute check beyond the stage timer, and nothing
is kept; `lm_solve` is a stage, timed in `means()` whenever a frame is
processed, so that a stage tap sees it with the record off too."""

from __future__ import annotations

import itertools
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Dict, Optional

# the text of the warning CUDA's sync-debug mode raises at each
# synchronizing operation
SYNC_WARNING = "called a synchronizing CUDA operation"

_ACTIVE: Optional["StageTimes"] = None   # the record of the frame being processed
_local = threading.local()               # per thread: depth of explicit waits
_hook = dict(users=0, before=None, filter=None, sync_mode=None)


def active() -> Optional["StageTimes"]:
    """The record of the frame being processed, None outside frames."""
    return _ACTIVE


class _HostWait:
    __slots__ = ("rec",)

    def __enter__(self):
        rec = _ACTIVE
        self.rec = rec if rec is not None and rec._on else None
        if self.rec is not None:
            self.rec.count("host_syncs")
            _local.quiet = getattr(_local, "quiet", 0) + 1

    def __exit__(self, *exc):
        if self.rec is not None:
            _local.quiet -= 1


def host_wait() -> _HostWait:
    """Context of one explicit wait of the host on the device: counts
    one `host_syncs`, and the synchronizing operations inside it are not
    counted again."""
    return _HostWait()


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if str(message).startswith(SYNC_WARNING):
        if _ACTIVE is not None and not getattr(_local, "quiet", 0):
            _ACTIVE.count("host_syncs")
        return
    _hook["before"](message, category, filename, lineno, file, line)


def _hook_syncs(on: bool) -> None:
    """While some record is on: CUDA's sync-debug mode on, and each of
    its warnings (all of them, not once a line) into `_on_warning`;
    other warnings go where they went before. The mode is process-wide,
    so is the hook."""
    import torch

    _hook["users"] += 1 if on else -1
    if on and warnings.showwarning is not _on_warning:
        _hook["before"] = warnings.showwarning
        warnings.showwarning = _on_warning
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        _hook["filter"] = warnings.filters[0]
        if torch.cuda.is_available():
            _hook["sync_mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
    elif not on and _hook["users"] == 0 and _hook["before"] is not None:
        if _hook["sync_mode"] is not None:
            torch.cuda.set_sync_debug_mode(_hook["sync_mode"])
        if warnings.showwarning is _on_warning:
            warnings.showwarning = _hook["before"]
        if _hook["filter"] in warnings.filters:
            warnings.filters.remove(_hook["filter"])
            warnings._filters_mutated()
        _hook.update(before=None, filter=None, sync_mode=None)


def _unix_offset_ns() -> int:
    """Unix ns minus `time.perf_counter_ns()`, from the closest of a few
    paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


class _Span:
    __slots__ = ("name", "id", "parent", "frame", "tags", "start", "end", "counters")

    def __init__(self, name, id_, parent, frame, tags, start):
        self.name, self.id, self.parent, self.frame = name, id_, parent, frame
        self.tags, self.start, self.end, self.counters = tags, start, None, {}


class StageTimes:
    """Running averages of named stage times, and the trace record
    (module docstring)."""

    def __init__(self):
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._on = False
        self._ids = itertools.count()
        self._local = threading.local()   # per thread: the stack of open spans
        self._spans = []                  # closed spans
        self._frames: Dict[int, _Span] = {}
        self._frame_counters: Dict[Optional[int], Dict[str, int]] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter_ns()
        span = self._open(name, t0) if self._on else None
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._total[name] = self._total.get(name, 0.0) + (t1 - t0) * 1e-9
            self._count[name] = self._count.get(name, 0) + 1
            if span is not None:
                self._close(span, t1)

    def totals(self) -> Dict[str, float]:
        return dict(self._total)

    def means(self) -> Dict[str, float]:
        return {k: self._total[k] / self._count[k] for k in self._total}

    # ------------------------------------------------------------------
    # the record
    # ------------------------------------------------------------------
    def record(self, on: bool = True) -> None:
        """Turn the record on or off; what it kept stays until export."""
        if bool(on) != self._on:
            self._on = bool(on)
            _hook_syncs(self._on)

    @contextmanager
    def frame(self, frame_id: int, **tags):
        """Scope of one frame's processing: this record is the active
        one inside it, and with the record on a `frame` span with the
        frame's id and `tags` is kept."""
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        span = None
        if self._on:
            span = self._open("frame", time.perf_counter_ns(), frame_id, tags)
            self._frames[frame_id] = span
        try:
            yield
        finally:
            if span is not None:
                self._close(span, time.perf_counter_ns())
            _ACTIVE = prev

    def tag(self, frame_id: int, **tags) -> None:
        """Set tags on the `frame` span of `frame_id`, open or closed."""
        if self._on and frame_id in self._frames:
            self._frames[frame_id].tags.update(tags)

    def count(self, name: str, n: int = 1, frame_id: Optional[int] = None) -> None:
        """Add `n` to counter `name` of the innermost open span and of
        its frame; with `frame_id`, of that frame and of its innermost
        open span, or of its `frame` span where none of it is open."""
        if not self._on:
            return
        stack = self._stack()
        span = stack[-1] if stack else None
        if frame_id is None:
            frame_id = None if span is None else span.frame
        elif span is None or span.frame != frame_id:
            span = self._frames.get(frame_id)
        if span is not None:
            span.counters[name] = span.counters.get(name, 0) + n
        c = self._frame_counters.setdefault(frame_id, {})
        c[name] = c.get(name, 0) + n

    def export(self) -> dict:
        """The record: `spans`, closed ones ordered by start, each
        {name, id, parent, frame, tags, start_ns, end_ns, counters}, and
        `frames`, the counters of each frame id (None: outside frames).
        Times are Unix ns (`clock`), as `torch.profiler` stamps events."""
        off = _unix_offset_ns()
        spans = sorted(self._spans, key=lambda s: s.start)
        return {"clock": "unix_ns",
                "spans": [dict(name=s.name, id=s.id, parent=s.parent, frame=s.frame,
                               tags=dict(s.tags), start_ns=s.start + off,
                               end_ns=s.end + off, counters=dict(s.counters))
                          for s in spans],
                "frames": {f: dict(c) for f, c in self._frame_counters.items()}}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name, t0, frame=None, tags=None) -> _Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if frame is None and parent is not None:
            frame = parent.frame
        span = _Span(name, next(self._ids), None if parent is None else parent.id,
                     frame, dict(tags or {}), t0)
        stack.append(span)
        return span

    def _close(self, span: _Span, t1: int) -> None:
        span.end = t1
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        self._spans.append(span)


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

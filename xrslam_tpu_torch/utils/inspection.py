"""Inspection: named debug/metrics taps (a copy of
`xrslam_tpu/utils/inspection.py`, with the same slot names).

The reference exposes internal quantities (timings, biases, landmarks,
misalignment angle) through a global slot table keyed by an enum
(reference: xrslam/include/xrslam/inspection.h:41-84 — InspectionSupport
with `inspect`/`inspect_debug` macros); the C ABI reads landmarks and
biases back out of it (xrslam-interface/src/XRSLAMManager.cpp:204-238).

Here the same idea is a process-global dict of slots with optional
subscriber callbacks; `enabled` gates the debug-only taps like the
reference's XRSLAM_ENABLE_DEBUG_INSPECTION build flag.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

# slot names used across the pipeline (reference inspection.h:41-57)
FEATURE_TRACKER_TIME = "feature_tracker_time"
BUNDLE_ADJUSTOR_SOLVE_TIME = "bundle_adjustor_solve_time"
BUNDLE_ADJUSTOR_MARGINALIZATION_TIME = "bundle_adjustor_marginalization_time"
FEATURE_TRACKER_FPS = "feature_tracker_fps"
ANGLE_MISALIGNMENT = "feature_tracker_angle_misalignment"
SLIDING_WINDOW_LANDMARKS = "sliding_window_landmarks"
SLIDING_WINDOW_TRACK_NUM = "sliding_window_track_num"
CURRENT_BG = "sliding_window_current_bg"
CURRENT_BA = "sliding_window_current_ba"
# painter taps (reference InspectPainter, inspection.h:41-57): the
# tracker publishes a per-frame dict {image, pts, tracked, lengths,
# frame_id, t} when PAINTER_ENABLE is truthy
PAINTER_ENABLE = "feature_tracker_painter_enable"
PAINTER_FRAME = "feature_tracker_painter"


class InspectionSupport:
    _lock = threading.Lock()
    _slots: Dict[str, Any] = {}
    _subs: Dict[str, List[Callable[[Any], None]]] = {}
    enabled: bool = True

    @classmethod
    def put(cls, name: str, value: Any) -> None:
        if not cls.enabled:
            return
        with cls._lock:
            cls._slots[name] = value
            subs = list(cls._subs.get(name, ()))
        for fn in subs:
            fn(value)

    @classmethod
    def get(cls, name: str, default: Any = None) -> Any:
        with cls._lock:
            return cls._slots.get(name, default)

    @classmethod
    def subscribe(cls, name: str, fn: Callable[[Any], None]) -> None:
        with cls._lock:
            cls._subs.setdefault(name, []).append(fn)

    @classmethod
    def unsubscribe(cls, name: str, fn: Callable[[Any], None]) -> None:
        with cls._lock:
            subs = cls._subs.get(name)
            if subs and fn in subs:
                subs.remove(fn)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._slots.clear()


def inspect(name: str, value: Any) -> None:
    InspectionSupport.put(name, value)


def inspect_get(name: str, default: Any = None) -> Any:
    return InspectionSupport.get(name, default)


def subscribe(name: str, fn: Callable[[Any], None]) -> None:
    InspectionSupport.subscribe(name, fn)


def unsubscribe(name: str, fn: Callable[[Any], None]) -> None:
    InspectionSupport.unsubscribe(name, fn)

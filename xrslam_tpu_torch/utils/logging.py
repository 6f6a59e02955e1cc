"""Logging (a copy of `xrslam_tpu/utils/logging.py`): console log with
the reference's format + a bounded message queue for UI consumption.

Reference: xrslam/src/xrslam/utility/debug.{h,cpp} — spdlog console
sink with pattern `[XRSLAM][level] message`, printf-style `log_message`
with level macros, and `runtime_assert`; plus the separate
message-queue `Logger` singleton (utility/logger.h:5-27) that the iOS
UI drains with getAllMessage().
"""

from __future__ import annotations

import logging as _pylogging
import threading
from collections import deque
from typing import List

_LEVELS = {
    "debug": _pylogging.DEBUG,
    "info": _pylogging.INFO,
    "notice": _pylogging.INFO,
    "warning": _pylogging.WARNING,
    "error": _pylogging.ERROR,
    "critical": _pylogging.CRITICAL,
}

_logger = _pylogging.getLogger("XRSLAM")
if not _logger.handlers:
    _h = _pylogging.StreamHandler()
    _h.setFormatter(_pylogging.Formatter("[XRSLAM][%(levelname)s] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(_pylogging.INFO)
    _logger.propagate = False


def set_level(level: str) -> None:
    _logger.setLevel(_LEVELS[level.lower()])


def log_message(level: str, fmt: str, *args) -> None:
    """printf-style log (reference utility/debug.h log_* macros)."""
    _logger.log(_LEVELS[level.lower()], fmt % args if args else fmt)


def log_debug(fmt, *a):
    log_message("debug", fmt, *a)


def log_info(fmt, *a):
    log_message("info", fmt, *a)


def log_warning(fmt, *a):
    log_message("warning", fmt, *a)


def log_error(fmt, *a):
    log_message("error", fmt, *a)


def runtime_assert(cond: bool, message: str) -> None:
    """reference utility/debug.h:30-46 — fatal in debug builds."""
    if not cond:
        log_message("critical", "%s", message)
        raise AssertionError(message)


class Logger:
    """Bounded message queue for UI consumption (reference
    utility/logger.h Logger::pushMessage/getAllMessage)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self, maxlen: int = 512):
        self._q: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "Logger":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Logger()
            return cls._instance

    def push_message(self, msg: str) -> None:
        with self._lock:
            self._q.append(msg)

    def get_all_messages(self) -> List[str]:
        with self._lock:
            out = list(self._q)
            self._q.clear()
        return out

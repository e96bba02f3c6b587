"""Structured logging layer.

The reference logs through slog with typed key-value fields, component
scoping, and level filtering (lighthouse/common/logging/src/lib.rs:1,
async_record.rs); raw stderr prints carry none of that. This is the same
model pared to what the framework needs:

    log = get_logger("beacon_chain")
    log.info("block imported", slot=42, root="0xab..", delay_ms=113)

    -> `Jul 30 12:00:01.123 INFO  beacon_chain        block imported   slot: 42, root: 0xab.., delay_ms: 113`

- component-scoped loggers with a shared global level
  (`LIGHTHOUSE_TPU_LOG_LEVEL`: trace|debug|info|warn|error|crit)
- machine-readable JSON lines with `LIGHTHOUSE_TPU_LOG_FORMAT=json`
- a bounded in-process ring of recent records feeding the ops API
  (the SSE log-streaming idiom of sse_logging_components.rs)
- writes are serialized; the sink defaults to stderr and is swappable for
  tests
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

LEVELS = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4, "crit": 5}
_LEVEL_NAMES = {v: k.upper() for k, v in LEVELS.items()}

_lock = threading.Lock()
_global_level = LEVELS.get(
    os.environ.get("LIGHTHOUSE_TPU_LOG_LEVEL", "info").lower(), 2
)
_json_mode = os.environ.get("LIGHTHOUSE_TPU_LOG_FORMAT", "") == "json"
_sink = None          # None = sys.stderr at call time (respects redirects)

#: last N records for the ops API / tests: (ts, level, component, msg, fields)
RECENT: deque = deque(maxlen=512)

#: record observers: callables fed (ts, level_name, component, msg, fields)
#: for every WARN-or-worse record (the flight recorder's log sink —
#: observability/flight_recorder.py). Deliberately NOT called for
#: info/debug: the hot path must not pay a callback per routine line.
_OBSERVER_MIN_LEVEL = LEVELS["warn"]
_observers: list = []
_in_observer = threading.local()


def add_observer(fn) -> None:
    if fn not in _observers:
        _observers.append(fn)


def remove_observer(fn) -> None:
    if fn in _observers:
        _observers.remove(fn)


def _notify_observers(ts, level_name, component, msg, fields) -> None:
    # reentrancy guard: an observer that itself logs (or crashes into an
    # error path that logs) must not recurse back into the observer chain
    if getattr(_in_observer, "active", False):
        return
    _in_observer.active = True
    try:
        for fn in list(_observers):
            try:
                fn(ts, level_name, component, msg, fields)
            except Exception:
                pass  # observers are best-effort; logging must never raise
    finally:
        _in_observer.active = False


def set_level(level: str) -> None:
    global _global_level
    _global_level = LEVELS[level.lower()]


def set_sink(sink) -> None:
    """Swap the output stream (None restores stderr-at-call-time)."""
    global _sink
    _sink = sink


class Logger:
    __slots__ = ("component",)

    def __init__(self, component: str):
        self.component = component

    def child(self, sub: str) -> "Logger":
        return Logger(f"{self.component}/{sub}")

    def _log(self, level: int, msg: str, fields: dict) -> None:
        if level < _global_level:
            return
        ts = time.time()
        RECENT.append((ts, _LEVEL_NAMES[level], self.component, msg, fields))
        if level >= _OBSERVER_MIN_LEVEL and _observers:
            _notify_observers(ts, _LEVEL_NAMES[level], self.component, msg, fields)
        if _json_mode:
            line = json.dumps(
                {
                    "ts": round(ts, 3),
                    "level": _LEVEL_NAMES[level],
                    "component": self.component,
                    "msg": msg,
                    **fields,
                }
            )
        else:
            stamp = time.strftime("%b %d %H:%M:%S", time.localtime(ts))
            ms = int((ts % 1) * 1000)
            kv = ", ".join(f"{k}: {v}" for k, v in fields.items())
            line = (
                f"{stamp}.{ms:03d} {_LEVEL_NAMES[level]:<5} "
                f"{self.component:<18} {msg}" + (f"   {kv}" if kv else "")
            )
        with _lock:
            out = _sink or sys.stderr
            print(line, file=out, flush=True)

    def trace(self, msg: str, **fields) -> None:
        self._log(0, msg, fields)

    def debug(self, msg: str, **fields) -> None:
        self._log(1, msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._log(2, msg, fields)

    def warn(self, msg: str, **fields) -> None:
        self._log(3, msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._log(4, msg, fields)

    def crit(self, msg: str, **fields) -> None:
        self._log(5, msg, fields)


_loggers: dict[str, Logger] = {}


def get_logger(component: str) -> Logger:
    got = _loggers.get(component)
    if got is None:
        got = _loggers[component] = Logger(component)
    return got

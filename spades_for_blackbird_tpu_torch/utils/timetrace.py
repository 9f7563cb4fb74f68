"""Time tracing to Chrome ``about:tracing`` JSON.

Replaces the reference's LLVM TimeTraceProfiler wrapper
(common/utils/perf/timetracer.hpp ``TIME_TRACE_SCOPE``, RAII init at
projects/spades/main.cpp:25-46, enabled by --trace-time): nested scopes
collected in-process and dumped as a Chrome trace; stages and hot phases
wrap themselves in ``scope(...)``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

_lock = threading.Lock()
_events: list[dict] = []
_enabled = False
_t0 = 0.0


def enable() -> None:
    global _enabled, _t0
    _enabled = True
    _t0 = time.perf_counter()
    with _lock:
        _events.clear()


def disable() -> None:
    """Stop collecting; the events collected so far stay for ``dump``."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def scope(name: str, **args):
    """TIME_TRACE_SCOPE equivalent."""
    if not _enabled:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        with _lock:
            _events.append({
                "name": name,
                "ph": "X",
                "ts": round((start - _t0) * 1e6, 1),
                "dur": round((end - start) * 1e6, 1),
                "pid": os.getpid(),
                "tid": threading.get_ident() % 100000,
                **({"args": args} if args else {}),
            })


@contextlib.contextmanager
def device_scope(name: str, device, **args):
    """``scope`` that, while tracing is on, waits for the card at its end,
    so the span holds the device work and not only its launch."""
    with scope(name, **args):
        yield
        if _enabled and device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)


def events() -> list[dict]:
    """A copy of the events collected since ``enable``."""
    with _lock:
        return list(_events)


def dump(path: str) -> None:
    """Write spades_time_trace-style Chrome trace JSON
    (main.cpp:25-46 writes spades_time_trace_<K>.json per stage run)."""
    with _lock:
        data = {"traceEvents": list(_events),
                "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(data, f)

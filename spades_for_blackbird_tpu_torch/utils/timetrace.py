"""Time tracing to Chrome ``about:tracing`` JSON.

Replaces the reference's LLVM TimeTraceProfiler wrapper
(common/utils/perf/timetracer.hpp ``TIME_TRACE_SCOPE``, RAII init at
projects/spades/main.cpp:25-46, enabled by --trace-time): nested scopes
collected in-process and dumped as a Chrome trace; stages and hot phases
wrap themselves in ``scope(...)``.

Each span's event carries an ``id`` and the ``parent`` id of the span
open around it on the same thread (None at the top), so a span's self
time is its ``dur`` less its children's. ``count`` adds to the innermost
open span (its ``args["counts"]``) and to the totals ``counters``
returns. The hand kernels' launches are recorded with
``record_launch`` and read with ``launches``. While tracing is off every
one of these returns after one check of the flag.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

_lock = threading.Lock()
_events: list[dict] = []
_counters: dict[str, int] = {}
_launches: list[dict] = []
_enabled = False
_t0 = 0.0
_ids = itertools.count(1)        # never reset: ids stay unique
_local = threading.local()       # .stack: this thread's open spans


def enable() -> None:
    global _enabled, _t0
    _enabled = True
    _t0 = time.perf_counter()
    with _lock:
        _events.clear()
        _counters.clear()
        _launches.clear()


def disable() -> None:
    """Stop collecting; what was collected stays readable (``events``,
    ``counters``, ``launches``, ``dump``) until the next ``enable``."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def origin() -> float:
    """The ``time.perf_counter`` instant that the events' ``ts`` count
    from (microseconds after it)."""
    return _t0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def scope(name: str, **args):
    """TIME_TRACE_SCOPE equivalent."""
    if not _enabled:
        yield
        return
    stack = _stack()
    span_id = next(_ids)
    parent = stack[-1][0] if stack else None
    counts: dict[str, int] = {}
    stack.append((span_id, counts))
    start = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        stack.pop()
        if counts:
            args = {**args, "counts": counts}
        with _lock:
            _events.append({
                "name": name,
                "ph": "X",
                "ts": round((start - _t0) * 1e6, 1),
                "dur": round((end - start) * 1e6, 1),
                "pid": os.getpid(),
                "tid": threading.get_ident() % 100000,
                "id": span_id,
                "parent": parent,
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


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``: on the innermost span open on
    this thread and in the totals since ``enable``."""
    if not _enabled:
        return
    stack = _stack()
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if stack:
            counts = stack[-1][1]
            counts[name] = counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of the counters' totals since ``enable``."""
    with _lock:
        return dict(_counters)


def record_launch(kernel: str, **fields) -> None:
    """Record one launch of the hand kernel ``kernel``. A field may be a
    tensor on the card, which is read only by ``launches``. Callers
    check ``enabled`` first, so that no record is built while off."""
    if not _enabled:
        return
    with _lock:
        _launches.append({"kernel": kernel, **fields})


def launches() -> list[dict]:
    """The launches recorded since ``enable``, in launch order, each a
    dict of ``kernel`` and its fields; the tensor fields (0-dim, of one
    dtype on one device) read from the card now, in one copy."""
    with _lock:
        records = [dict(r) for r in _launches]
    places = [(r, key) for r in records for key, value in r.items()
              if hasattr(value, "tolist")]
    if places:
        import torch
        values = torch.stack([r[key] for r, key in places]).tolist()
        for (r, key), value in zip(places, values):
            r[key] = value
    return records


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

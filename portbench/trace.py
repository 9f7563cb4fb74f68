"""What a traced run records, from the benchmark's side of the program.

* Spans: the program's time trace (``utils/timetrace``), switched on with
  its public ``enable`` before each job and read with ``events`` after it.
  Its spans wait for the card at their end while it is on.
* Launches: the shape of every launch of the two hand kernels on the main
  path, recorded by wrapping their wrappers' ``launch`` from here
  (``ops/kmer_cuda.py``, ``ops/seg_sum.py``), in launch order. The ordered
  sum's kept rows and reached slots are counted on a side stream of the
  recorder's own.
* Device activity: ``torch.profiler`` over the window, device events only
  (kernels, copies, sets), on the host's wall clock, less every event of
  the recorder's side stream: the trace holds the program's work alone.

``Trace`` holds all of it on one clock, the host's ``perf_counter``
seconds, as plain data (``from_dict`` builds one from a record), so that
each metric reader can be run on a recorded trace.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    kind: str = ""                 # "assembly" or "correction"
    window: tuple = (0.0, 0.0)     # host seconds
    jobs: int = 0
    spans: list = field(default_factory=list)     # [name, start, end]
    device: list = field(default_factory=list)    # [name, start, end]
    launches: dict = field(default_factory=dict)  # kernel -> [shape dict]
    profiler_found_device: bool = False
    side_events: int = 0           # the recorder's events left out

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls(**{**d, "window": tuple(d["window"])})

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_events(self, needle: str) -> list:
        """Device events whose name holds ``needle``, in time order."""
        return sorted((e for e in self.device if needle in e[0]),
                      key=lambda e: e[1])


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that at least one (start, end) covers."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class LaunchRecorder:
    """Wraps ``launch`` of the k-mer extraction and of the ordered sum,
    recording each launch's shape. The ordered sum's kept rows and
    reached slots are counted on the card beside the launch, on the
    recorder's ``side`` stream (which waits for the program's stream and
    is never waited for), and read once the window has closed."""

    def __init__(self, device):
        import torch
        self.side = torch.cuda.Stream(device)
        self.kmer: list = []
        self.seg: list = []
        self._undo: list = []

    def __enter__(self):
        import torch
        from spades_for_blackbird_tpu_torch.ops import kmer_cuda, seg_sum

        kmer = kmer_cuda.extract_sort_keys
        kmer_launch = kmer.launch

        def kmer_recorded(codes, lengths, k, keys, valid, fwd=None):
            R, L = codes.shape
            self.kmer.append({"R": int(R), "L": int(L), "k": int(k),
                              "strand": fwd is not None})
            return kmer_launch(codes, lengths, k, keys, valid, fwd)

        seg = seg_sum.seg_sum
        seg_launch = seg.launch

        side = self.side

        def seg_recorded(out, slot, vals, perm, limit):
            side.wait_stream(torch.cuda.current_stream(slot.device))
            with torch.cuda.stream(side):
                inside = slot < limit
                starts = inside[1:] & (slot[1:] != slot[:-1])
                counts = torch.stack([inside.sum(),
                                      starts.sum() + inside[:1].sum()])
            slot.record_stream(side)
            self.seg.append({"cols": int(vals.shape[1]),
                             "itemsize": int(out.element_size()),
                             "slot_itemsize": int(slot.element_size()),
                             "perm": perm is not None, "counts": counts})
            return seg_launch(out, slot, vals, perm, limit)

        kmer.launch = kmer_recorded
        seg.launch = seg_recorded
        self._undo = [(kmer, "launch"), (seg, "launch")]
        return self

    def __exit__(self, *exc):
        for obj, name in self._undo:
            obj.__dict__.pop(name, None)
        self.side.synchronize()
        for rec in self.seg:
            counts = rec.pop("counts", None)
            if counts is not None:
                kept, slots = counts.tolist()
                rec["kept"], rec["slots"] = int(kept), int(slots)
        return False

    def launches(self) -> dict:
        return {"kmer_extract": list(self.kmer), "seg_sum": list(self.seg)}


MARK_CYCLES = 1000  # the spin kernel that names the side stream in a trace


@contextlib.contextmanager
def device_profiler(trace: Trace, side=None):
    """``torch.profiler`` over the block, device activity only; on exit
    its kernels, copies and sets go into ``trace.device`` on the host's
    ``perf_counter`` clock (the profiler stamps the wall clock). Where
    ``side`` is a stream, a spin kernel is run on it alone before the
    block and after it, and every event on a spin kernel's stream is left
    out (a profiler can drop the first events of a session)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    if side is not None:
        mark()
    try:
        yield
    finally:
        if side is not None:
            mark()
        torch.cuda.synchronize()
        offset = time.time_ns() * 1e-9 - time.perf_counter()
        prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        skip = {e.device_resource_id() for e in events
                if side is not None and "spin_kernel" in e.name()}
        if side is not None and not skip:
            print("[portbench] the side stream's spin kernels are not in the "
                  "profiler's trace: its events count as the program's",
                  file=sys.stderr, flush=True)
        for e in events:
            if e.device_resource_id() in skip:
                trace.side_events += 1
                continue
            start = e.start_ns() * 1e-9 - offset
            trace.device.append([e.name(), start,
                                 start + e.duration_ns() * 1e-9])
        trace.profiler_found_device = bool(trace.device)


class SpanCollector:
    """The program's time trace around each job, on the host's clock."""

    def __init__(self, trace: Trace):
        self.trace = trace

    @contextlib.contextmanager
    def job(self):
        from spades_for_blackbird_tpu_torch.utils import timetrace
        t0 = time.perf_counter()
        timetrace.enable()
        try:
            yield
        finally:
            timetrace.disable()
            for ev in timetrace.events():
                start = t0 + ev["ts"] * 1e-6
                self.trace.spans.append(
                    [ev["name"], start, start + ev["dur"] * 1e-6])

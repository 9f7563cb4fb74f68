"""Arithmetic the metric readers share: spans a job, kernel rooflines over
the device trace, the card's busy time. A reader that finds nothing to
read returns None, and the harness leaves its metric out of the line."""

from __future__ import annotations

from . import kernels
from .trace import Trace, union_seconds


def span_seconds_per_job(run, names) -> float | None:
    """Seconds a job in which any of the spans ``names`` was open (their
    union, so nested spans count once), or None where none was."""
    t = run.trace
    if t is None or not t.jobs:
        return None
    hits = [(s, e) for n, s, e in t.spans if n in names]
    if not hits:
        return None
    return union_seconds(hits, t.window[0], t.window[1]) / t.jobs


def busy_seconds(t: Trace) -> float:
    """Seconds of the window in which a kernel, copy or set ran."""
    return union_seconds([(s, e) for _, s, e in t.device], *t.window)


def idle_share(run) -> float | None:
    """Percent of the window with nothing on the card."""
    t = run.trace
    if t is None or not t.profiler_found_device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(t) / t.window_s)


def _matched(t: Trace, kernel: str, needle: str):
    """The recorded launches of ``kernel`` beside the device events whose
    name holds ``needle``, or None where they do not pair one to one."""
    launches = t.launches.get(kernel) or []
    events = t.kernel_events(needle)
    if not launches or len(events) != len(launches):
        return None
    return launches, events


def kmer_extract_roofline(run) -> float | None:
    """Percent: the least time of every launch of the k-mer extraction,
    from its shape, over the kernel's device time."""
    t = run.trace
    pairs = _matched(t, "kmer_extract", "kmer_extract_kernel") if t else None
    if pairs is None:
        return None
    launches, events = pairs
    least = sum(kernels.kmer_bound(x["R"], x["L"], x["k"], x["strand"])[0]
                for x in launches)
    spent = sum(e - s for _, s, e in events)
    return 100.0 * least / spent if spent > 0 else None


def seg_sum_roofline(run) -> float | None:
    """Percent: the least time of every launch of the ordered sum (bytes
    at the memory rate, adds at the float32 rate) over its device time."""
    t = run.trace
    pairs = _matched(t, "seg_sum", "seg_sum_kernel") if t else None
    if pairs is None:
        return None
    launches, events = pairs
    least = sum(kernels.seg_sum_bound(
        x["kept"], x["cols"], x["itemsize"], x["slot_itemsize"], x["perm"],
        x["slots"])[0] for x in launches)
    spent = sum(e - s for _, s, e in events)
    return 100.0 * least / spent if spent > 0 else None

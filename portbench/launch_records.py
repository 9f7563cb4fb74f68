"""Kernel rooflines from the program's own launch records.

The port's time trace records every launch of its two hand kernels
(``timetrace.launches()``: the k-mer extraction's shape; the ordered
sum's shape with the kept rows and reached slots its kernel counts on the
card). The program clears them at each job's start, so after the window
they hold the window's last job. That job's device events are those that
started after its trace did (``timetrace.origin()``, on the device
trace's ``perf_counter`` clock). The rooflines are ``readers.py``'s, with
the same bounds and pairing, over that job alone.

The benchmark's files also run over earlier checkouts of the program,
whose time trace keeps no launch records: there, as where the records and
the events do not pair, each reader returns None.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

from . import readers


def program_records():
    """(the program's launch records, its trace's origin), or None where
    its time trace keeps no launch records."""
    from spades_for_blackbird_tpu_torch.utils import timetrace
    launches = getattr(timetrace, "launches", None)
    origin = getattr(timetrace, "origin", None)
    if launches is None or origin is None:
        return None
    return launches(), origin()


def last_job(run):
    """``run`` as the readers see it, its trace cut to the last job: the
    program's launch records, the device events after the job's origin;
    None where there is no device trace or no record to read."""
    t = run.trace
    if t is None or not t.jobs or not t.profiler_found_device:
        return None
    got = program_records()
    if got is None:
        return None
    records, t0 = got
    launches: dict = {}
    for r in records:
        launches.setdefault(r["kernel"], []).append(r)
    job = dataclasses.replace(t, launches=launches,
                              device=[e for e in t.device if e[1] >= t0])
    return SimpleNamespace(trace=job, kind=run.kind)


def kmer_extract_roofline(run) -> float | None:
    """Percent: ``readers.kmer_extract_roofline`` over the last job, from
    the shapes the program recorded."""
    job = last_job(run)
    return readers.kmer_extract_roofline(job) if job else None


def seg_sum_roofline(run) -> float | None:
    """Percent: ``readers.seg_sum_roofline`` over the last job, from the
    shapes and counts the program recorded."""
    job = last_job(run)
    return readers.seg_sum_roofline(job) if job else None

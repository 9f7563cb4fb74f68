"""The readers of the spans, the counter and the launch records that the
program's trace holds inside its phases: each on a recorded trace and a
stubbed or CPU-made program record, and None where its span, counter or
record is missing."""

from __future__ import annotations

import os

import pytest

from portbench import harness
from portbench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    return harness.load_module(os.path.join(ROOT, "metrics", f"{name}.py"),
                               f"test_trace_reader_{name}".replace(".", "_"))


class FakeRun:
    def __init__(self, trace):
        self.trace = trace
        self.kind = "assembly"


def recorded(jobs: int = 1) -> Trace:
    """One job in a 10 s window: read_parse twice inside read conversion
    (one library's two files), the compression inside the pre-simplify
    save, a nested repeat that counts once."""
    return Trace.from_dict({
        "kind": "assembly", "window": [100.0, 110.0], "jobs": jobs,
        "spans": [["stage:read_conversion", 100.0, 102.0],
                  ["read_parse", 100.0, 100.75],
                  ["read_parse", 100.75, 101.5],
                  ["read_upload", 101.75, 102.0],
                  ["phase_checkpoint", 105.0, 106.0],
                  ["checkpoint_fetch", 105.0, 105.1],
                  ["checkpoint_compress", 105.1, 106.0],
                  ["checkpoint_compress", 105.2, 105.5]]})


@pytest.mark.parametrize("name, want", [("fastq_parse_s", 1.5),
                                        ("checkpoint_compress_s", 0.9)])
def test_span_readers_inside_phases(name, want):
    assert reader(name).read(FakeRun(recorded())) == pytest.approx(want)
    assert reader(name).read(FakeRun(recorded(jobs=2))) == \
        pytest.approx(want / 2)
    t = recorded()
    t.spans = [s for s in t.spans if s[0] not in ("read_parse",
                                                  "checkpoint_compress")]
    assert reader(name).read(FakeRun(t)) is None
    assert reader(name).read(FakeRun(None)) is None


def test_fit_evaluations_reads_the_last_jobs_counter(monkeypatch):
    mod = reader("coverage_fit_evaluations")
    monkeypatch.setattr(mod, "counters", lambda: {
        "fit_evaluations": 4321, "fit_rounds": 9, "fit_path.reference": 3})
    assert mod.read(FakeRun(recorded())) == 4321
    assert mod.read(FakeRun(recorded(jobs=0))) is None
    assert mod.read(FakeRun(recorded(jobs=2))) is None  # the last job's
    assert mod.read(FakeRun(None)) is None
    monkeypatch.setattr(mod, "counters", lambda: {"fit_rounds": 9})
    assert mod.read(FakeRun(recorded())) is None
    monkeypatch.setattr(mod, "counters", dict)   # a program without them
    assert mod.read(FakeRun(recorded())) is None


def test_fit_evaluations_counters_come_from_the_program(monkeypatch):
    from spades_for_blackbird_tpu_torch.utils import timetrace
    mod = reader("coverage_fit_evaluations")
    timetrace.enable()
    timetrace.count("fit_evaluations", 17)
    timetrace.disable()
    assert mod.read(FakeRun(recorded())) == 17
    monkeypatch.delattr(timetrace, "counters")   # an earlier program
    assert mod.counters() == {} and mod.read(FakeRun(recorded())) is None


def traced_job(kind: str = "assembly"):
    """A window of two jobs on the device trace's clock, the program's
    records of the last one made by its time trace on the CPU (the counts
    as tensors, as the card's are): one k-mer extraction and two ordered
    sums after the job's origin, one of each before it."""
    import torch
    from spades_for_blackbird_tpu_torch.utils import timetrace
    timetrace.enable()
    timetrace.record_launch("kmer_extract", R=1000, L=100, k=56,
                            strand=False)
    for kept, slots in ((900, 40), (300, 7)):
        timetrace.record_launch(
            "seg_sum", cols=2, itemsize=4, slot_itemsize=8, perm=True,
            limit=50, M=1000, kept=torch.tensor(kept),
            slots=torch.tensor(slots))
    timetrace.disable()
    t0 = timetrace.origin()
    trace = Trace(kind=kind, window=(t0 - 5.0, t0 + 5.0), jobs=2,
                  profiler_found_device=True, device=[
                      ["kmer_extract_kernel", t0 - 2.0, t0 - 1.0],
                      ["seg_sum_kernel<float>", t0 - 0.5, t0 - 0.4],
                      ["kmer_extract_kernel", t0 + 1.0, t0 + 1.004],
                      ["seg_sum_kernel<float>", t0 + 2.0, t0 + 2.002],
                      ["seg_sum_kernel<float>", t0 + 3.0, t0 + 3.001]])
    run = FakeRun(trace)
    run.kind = kind
    return run


@pytest.mark.parametrize("kernel", ["kmer_extract", "seg_sum"])
def test_rooflines_from_the_programs_records(kernel, monkeypatch):
    from portbench import kernels, launch_records
    run = traced_job()
    if kernel == "kmer_extract":
        want = 100 * kernels.kmer_bound(1000, 100, 56, False)[0] / 0.004
    else:
        want = 100 * (kernels.seg_sum_bound(900, 2, 4, 8, True, 40)[0]
                      + kernels.seg_sum_bound(300, 2, 4, 8, True, 7)[0]) \
            / 0.003
    for cell in ("assembly", "correction"):
        mod = reader(f"{kernel}_roofline.program.{cell}")
        got = mod.read(traced_job(cell))
        assert got == pytest.approx(want, rel=1e-6)
        assert mod.read(traced_job("correction" if cell == "assembly"
                                   else "assembly")) is None
    mod = reader(f"{kernel}_roofline.program.assembly")
    run.trace.device.append([f"{kernel}_kernel", run.trace.window[1],
                             run.trace.window[1] + 1e-3])
    assert mod.read(run) is None                    # do not pair
    assert mod.read(FakeRun(None)) is None
    monkeypatch.setattr(launch_records, "program_records", lambda: None)
    assert mod.read(traced_job()) is None           # an earlier program

"""The reader of the seconds a job waits for the coverage fit (the span
coverage_wait): on a recorded trace in which the fit runs on a worker
thread beside the rung, and None on a program without the span."""

from __future__ import annotations

import os

import pytest

from portbench import harness
from portbench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeRun:
    def __init__(self, trace):
        self.trace = trace
        self.kind = "assembly"


def recorded(jobs: int = 1, wait: bool = True) -> Trace:
    """Two rungs in a 10 s window: each fit on the worker beside the
    graph build and the save's compression; the first rung waits 0.4 s
    inside its save, the second finds its fit done (a join of no
    length)."""
    spans = [["coverage_model_fit", 101.0, 104.4],
             ["coverage_em", 101.0, 104.4],
             ["condense", 101.2, 102.0],
             ["phase_checkpoint", 102.0, 105.0],
             ["checkpoint_compress", 102.1, 104.0],
             ["coverage_wait", 104.0, 104.4],
             ["checkpoint_compress", 104.4, 105.0],
             ["coverage_model_fit", 106.0, 107.0],
             ["coverage_em", 106.0, 107.0],
             ["phase_checkpoint", 107.0, 109.0],
             ["coverage_wait", 108.5, 108.5]]
    if not wait:
        spans = [s for s in spans if s[0] != "coverage_wait"]
    return Trace.from_dict({"kind": "assembly", "window": [100.0, 110.0],
                            "jobs": jobs, "spans": spans})


def test_coverage_wait_reads_the_joins_alone():
    mod = harness.load_module(os.path.join(ROOT, "metrics",
                                           "coverage_wait_s.py"),
                              "test_trace_reader_coverage_wait_s")
    assert mod.read(FakeRun(recorded())) == pytest.approx(0.4)
    assert mod.read(FakeRun(recorded(jobs=2))) == pytest.approx(0.2)
    fit = harness.load_module(os.path.join(ROOT, "metrics",
                                           "coverage_fit_s.py"),
                              "test_trace_reader_coverage_fit_s")
    assert fit.read(FakeRun(recorded())) == pytest.approx(4.4)
    assert mod.read(FakeRun(recorded(wait=False))) is None  # the parent
    assert mod.read(FakeRun(None)) is None

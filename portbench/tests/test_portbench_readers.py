"""Each metric reader on a recorded trace, and the contract's shape of
BENCHMARK.json."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import harness, kernels
from portbench.trace import Trace, union_seconds

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOT = os.path.join(REPO, "portbench")
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))

KMER = "void kmer_extract_kernel<4>(unsigned char const*, int)"
SEG = "void seg_sum_kernel<float, int>(Job<float, int>)"


def recorded(kind: str) -> Trace:
    """Two jobs in a 10 s window: spans nested and repeated, two k-mer and
    one sum launch, a copy, and idle gaps inside known spans."""
    return Trace.from_dict({
        "kind": kind, "window": [100.0, 110.0], "jobs": 2,
        "spans": [["stage:read_conversion", 100.0, 101.0],
                  ["stage:error_correction", 101.0, 104.0],
                  ["hammer_subcluster", 102.0, 103.0],
                  ["hammer_count", 101.0, 101.5],
                  ["count_kmers", 104.0, 105.0],
                  ["condense", 105.0, 106.0],
                  ["condense", 105.2, 105.8],       # nested: counts once
                  ["simplify", 106.0, 107.0],
                  ["stage:gap_closing", 107.0, 107.5],
                  ["stage:repeat_resolution", 107.5, 108.0],
                  ["phase_checkpoint", 108.0, 108.4],
                  ["coverage_model_fit", 108.4, 109.0]],
        "device": [[KMER, 101.0, 101.002], [KMER, 104.0, 104.001],
                   [SEG, 105.0, 105.004],
                   ["Memcpy HtoD (Pageable -> Device)", 100.5, 100.6],
                   ["other", 99.0, 100.2]],           # starts before
        "launches": {
            "kmer_extract": [
                {"R": 1_840_000, "L": 100, "k": 22, "strand": True},
                {"R": 920_000, "L": 100, "k": 56, "strand": False}],
            "seg_sum": [{"cols": 1, "itemsize": 4,
                         "slot_itemsize": 4, "perm": True, "kept": 800,
                         "slots": 100}]},
        "profiler_found_device": True})


class FakeRun:
    def __init__(self, trace, kind):
        self.trace = trace
        self.kind = kind


def reader(name):
    return harness.load_module(os.path.join(ROOT, "metrics", f"{name}.py"),
                               f"test_reader_{name}".replace(".", "_"))


def test_every_metric_has_a_reader_and_a_unit():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for name in names:
        assert callable(reader(name).read)


@pytest.mark.parametrize("name, want", [
    ("read_conversion_s", 0.5), ("error_correction_s", 1.5),
    ("hammer_subcluster_s", 0.5), ("hammer_count_s", 0.25),
    ("count_kmers_s", 0.5), ("graph_build_s", 0.5), ("simplify_s", 0.5),
    ("repeat_resolution_s", 0.5), ("checkpoint_s", 0.2),
    ("coverage_fit_s", 0.3)])
def test_span_readers(name, want):
    got = reader(name).read(FakeRun(recorded("assembly"), "assembly"))
    assert got == pytest.approx(want)


def test_span_reader_finds_nothing_without_the_span():
    t = recorded("assembly")
    t.spans = [s for s in t.spans if s[0] != "simplify"]
    assert reader("simplify_s").read(FakeRun(t, "assembly")) is None
    assert reader("simplify_s").read(FakeRun(None, "assembly")) is None


def test_idle_share_and_busy_seconds():
    t = recorded("assembly")
    busy = 0.2 + 0.1 + 0.002 + 0.001 + 0.004
    assert harness.breakdown(t)["device_ops"][0][0] == "other"
    got = reader("device_idle_share.assembly").read(FakeRun(t, "assembly"))
    assert got == pytest.approx(100 * (1 - busy / 10))
    assert reader("device_idle_share.correction").read(
        FakeRun(t, "assembly")) is None
    t.profiler_found_device = False
    assert reader("device_idle_share.assembly").read(
        FakeRun(t, "assembly")) is None


def test_rooflines():
    t = recorded("correction")
    least = (kernels.kmer_bound(1_840_000, 100, 22, True)[0]
             + kernels.kmer_bound(920_000, 100, 56)[0])
    got = reader("kmer_extract_roofline.correction").read(
        FakeRun(t, "correction"))
    assert got == pytest.approx(100 * least / 0.003)
    seg = kernels.seg_sum_bound(800, 1, 4, 4, True, 100)[0]
    got = reader("seg_sum_roofline.correction").read(FakeRun(t, "correction"))
    assert got == pytest.approx(100 * seg / 0.004)
    assert reader("seg_sum_roofline.assembly").read(
        FakeRun(t, "correction")) is None
    # launches and kernels that do not pair one to one: nothing to read
    t.device = t.device[1:]
    assert reader("kmer_extract_roofline.correction").read(
        FakeRun(t, "correction")) is None


def test_breakdown_names_gaps_by_the_innermost_open_span():
    b = harness.breakdown(recorded("assembly"))
    assert len(b["device_ops"]) == 4   # the two k-mer launches as one
    # the longest gap, 105.004-110, has repeat resolution open at its
    # middle; the next, 101.002-104, subclustering inside correction
    assert b["idle_gaps"][0][0] == "stage:repeat_resolution"
    assert b["idle_gaps"][0][1] == pytest.approx(110 - 105.004)
    assert b["idle_gaps"][1][0] == "hammer_subcluster"
    assert b["idle_gaps"][1][1] == pytest.approx(104 - 101.002)


def test_union_seconds():
    assert union_seconds([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert union_seconds([(0, 2)], 1, 10) == 1
    assert union_seconds([], 0, 1) == 0


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "cells",
                                           f"{w['name']}.json"))
        assert os.path.exists(os.path.join(ROOT, "traffic",
                                           f"{w['traffic']}.json"))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])

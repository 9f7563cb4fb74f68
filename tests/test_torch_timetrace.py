"""The port's time trace (``utils/timetrace``): span ids and parents on
each thread, counters on the innermost span and in the totals, launch
records, and nothing kept or allocated while tracing is off."""

import threading
import tracemalloc

import pytest

from spades_for_blackbird_tpu_torch.utils import timetrace


@pytest.fixture
def tracing():
    timetrace.enable()
    yield
    timetrace.disable()


def test_nested_spans_have_ids_and_parents_per_thread(tracing):
    def worker():
        with timetrace.scope("thread_outer"):
            with timetrace.scope("thread_inner"):
                pass

    with timetrace.scope("outer", k=21):
        with timetrace.scope("inner"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        with timetrace.scope("second"):
            pass
    events = {ev["name"]: ev for ev in timetrace.events()}
    assert len({ev["id"] for ev in events.values()}) == 5
    assert events["outer"]["parent"] is None
    assert events["inner"]["parent"] == events["outer"]["id"]
    assert events["second"]["parent"] == events["outer"]["id"]
    # another thread's spans nest on that thread only
    assert events["thread_outer"]["parent"] is None
    assert events["thread_inner"]["parent"] == events["thread_outer"]["id"]
    for ev in events.values():
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= ev.keys()
        assert ev["ph"] == "X" and ev["dur"] >= 0
    assert events["outer"]["args"] == {"k": 21}
    assert "args" not in events["inner"]
    assert 0 < timetrace.origin()


def test_count_lands_on_the_innermost_span_and_in_the_totals(tracing):
    timetrace.count("outside")
    with timetrace.scope("outer"):
        timetrace.count("bytes", 10)
        with timetrace.scope("inner"):
            timetrace.count("bytes", 5)
            timetrace.count("reads")
            timetrace.count("reads")
    events = {ev["name"]: ev for ev in timetrace.events()}
    assert events["outer"]["args"]["counts"] == {"bytes": 10}
    assert events["inner"]["args"]["counts"] == {"bytes": 5, "reads": 2}
    timetrace.disable()
    # the totals stay readable after disable, until the next enable
    assert timetrace.counters() == {"outside": 1, "bytes": 15, "reads": 2}
    timetrace.enable()
    assert timetrace.counters() == {} and timetrace.events() == []


def test_launch_records_keep_order_and_read_tensors_late(tracing):
    torch = pytest.importorskip("torch")
    pool = torch.zeros((2, 2), dtype=torch.int64)
    timetrace.record_launch("kmer_extract", R=4, L=100, k=22, strand=False)
    timetrace.record_launch("seg_sum", cols=1, kept=pool[0, 0],
                            slots=pool[0, 1])
    pool[0] = torch.tensor([7, 3])  # written after the launch is recorded
    assert timetrace.launches() == [
        {"kernel": "kmer_extract", "R": 4, "L": 100, "k": 22,
         "strand": False},
        {"kernel": "seg_sum", "cols": 1, "kept": 7, "slots": 3}]


def test_off_keeps_nothing_and_allocates_nothing():
    timetrace.enable()
    timetrace.disable()
    with timetrace.scope("off"):
        timetrace.count("bytes", 3)
    timetrace.record_launch("seg_sum", cols=1)
    assert timetrace.events() == [] and timetrace.counters() == {}
    assert timetrace.launches() == []

    def calls():
        for _ in range(2000):
            timetrace.count("bytes", 3)
            timetrace.count("reads")

    calls()  # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, timetrace.__file__)]
    grown = after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno")
    assert sum(d.size_diff for d in grown) == 0

"""The readers of the program's own spans (``program_spans.py`` and the
five metrics that take them) on a synthetic trace, with nothing recorded
and without the recorder; a traced run of each cell on the CPU, whose
set A the spans see; on the card, every top-level program span of a whole
traced cycle inside its benchmark span after the one offset."""

import time

import pytest
import torch

from benchmark import harness, program_spans, tracing
from tfqmrgpu_tpu_torch import profiling

from tiny import cell_names, tiny_cell

EPOCH_US = 1_790_000_000_000_000      # where the program's clock stands

# one point on the Trace's clock (us): set A, solve, read X
BENCH = [("bench.set_a", 0.0, 100.0), ("bench.solve", 110.0, 300.0),
         ("bench.get_x", 310.0, 350.0)]
EVENTS = [("prep", 112.0, 114.0), ("graph", 121.0, 200.0),
          ("graph", 210.0, 270.0), ("d2h", 320.0, 330.0)]
DEVICE_MS = 0.149
PROGRAM = [          # (name, start, end, children): the same clock,
    #                    each call opening with its benchmark span
    ("tfq.set_a", 0, 99, [
        ("planes", 2, 4, []), ("upload", 5, 9, []),
        ("multiply", 10, 90, [
            ("pair_table", 10, 11, []), ("copies", 11, 15, []),
            ("pair_y", 15, 20, []), ("schedule", 20, 80, []),
            ("schedule_upload", 80, 88, [])]),
        ("refill", 90, 95, [])]),
    ("tfq.solve.pairs", 110, 290, [
        ("prepare", 111, 115, []), ("fill", 116, 118, []),
        ("launch", 118, 120, []), ("read", 120, 280, []),
        ("finish", 281, 289, [])]),
    ("tfq.get_x", 310, 349, [("copy", 312, 331, []),
                             ("unpack", 331, 348, [])]),
]
READERS = ("schedule_builds_per_set_a", "set_a_plan_pct",
           "graph_ms_per_iter", "solve_overhead_ms",
           "solve_idle_in_graph_pct")


def _keep(tree, shift_us=0.0, parent=None, device_ms=DEVICE_MS):
    for name, a, b, kids in tree:
        ns = [int(1000 * (EPOCH_US + v + shift_us)) for v in (a, b)]
        attrs = {"device_ms": device_ms} if name == "launch" else {}
        s = profiling.add_span(name, *ns, parent=parent, **attrs)
        _keep(kids, shift_us, s, device_ms)


def _trace(points=1, iterations=10):
    spans = [(n, a + 1000.0 * k, b + 1000.0 * k) for k in range(points)
             for n, a, b in BENCH]
    events = [(n, a + 1000.0 * k, b + 1000.0 * k) for k in range(points)
              for n, a, b in EVENTS]
    return tracing.Trace(
        solves=[{"iterations": iterations} for _ in range(points)],
        spans=spans, events=events)


def _read(t) -> dict:
    return {name: harness.metric_reader(name)(t) for name in READERS}


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def test_the_five_readers_on_one_point():
    with profiling.recording():
        _keep(PROGRAM)
    got = _read(_trace())
    assert got["schedule_builds_per_set_a"] == 1.0
    assert got["set_a_plan_pct"] == pytest.approx(100.0 * 78 / 99)
    assert got["graph_ms_per_iter"] == pytest.approx(DEVICE_MS / 10)
    assert got["solve_overhead_ms"] == pytest.approx(0.180 - DEVICE_MS)
    # idle inside the solve: 2 + 7 + 10 + 20 us; from launch to read's
    # end: 3 + 10 + 10
    assert got["solve_idle_in_graph_pct"] == pytest.approx(100.0 * 23 / 39)


def test_the_offset_takes_the_traced_solves_among_others():
    """Spans recorded before the cycle (a warm solve) and a program clock
    that jitters by 3 us: the offset is the traced calls' median."""
    with profiling.recording():
        _keep(PROGRAM, shift_us=-50_000.0)           # outside the window
        for k, jitter in enumerate((0.0, 3.0, 1.0)):
            _keep(PROGRAM, shift_us=1000.0 * k + jitter)
    t = _trace(points=3)
    spans = program_spans.aligned(t)
    assert len(program_spans.calls(spans, "tfq.solve.")) == 3
    assert [round(s.start_us - 1000.0 * k, 6) for k, s in enumerate(
        sorted(program_spans.calls(spans, "tfq.solve.").values(),
               key=lambda s: s.start_us))] == [109.0, 112.0, 110.0]
    got = _read(t)
    assert got["schedule_builds_per_set_a"] == 1.0
    assert got["graph_ms_per_iter"] == pytest.approx(DEVICE_MS / 10)


def test_a_second_schedule_shows():
    with profiling.recording():
        _keep(PROGRAM)
        top = [s for s in profiling.spans() if s.name == "multiply"][0]
        profiling.add_span("schedule", top.start_ns, top.start_ns + 10,
                           parent=top)
    assert _read(_trace())["schedule_builds_per_set_a"] == 2.0


def test_nothing_recorded_reads_none():
    assert all(v is None for v in _read(_trace()).values())


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    with profiling.recording():
        _keep(PROGRAM)
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.recorded() == []
    assert all(v is None for v in _read(_trace()).values())


def test_a_solve_without_a_graph_reads_only_set_a():
    """The CPU's plain driver: no launch, read or device time."""
    tree = [(n, a, b, [k for k in kids if k[0] not in ("fill", "launch",
                                                       "read")])
            for n, a, b, kids in PROGRAM]
    with profiling.recording():
        _keep(tree)
    got = _read(_trace())
    assert got["schedule_builds_per_set_a"] == 1.0
    assert got["set_a_plan_pct"] > 0
    assert [got[k] for k in READERS[2:]] == [None] * 3


def test_a_launch_without_device_time_reads_none():
    with profiling.recording():
        _keep(PROGRAM, device_ms=None)
        for s in profiling.spans():
            s.attrs.pop("device_ms", None)
    got = _read(_trace())
    assert got["graph_ms_per_iter"] is None
    assert got["solve_overhead_ms"] is None


@pytest.mark.parametrize("name", cell_names())
def test_a_traced_cpu_run_sees_set_a(name):
    """On the card's engine, 'pairs' (at this size 'auto' takes 'dense')."""
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    cell.config["engine"] = "pairs"
    r = harness.run(cell, 5, 0.0, True, "cpu", time.perf_counter())
    assert r["engine"] == "pairs" and r["correct"], r["checks"]
    m = r["metrics"]
    assert m["schedule_builds_per_set_a"]["value"] == 1.0
    assert 0 < m["set_a_plan_pct"]["value"] <= 100
    for k in ("graph_ms_per_iter", "solve_overhead_ms",
              "solve_idle_in_graph_pct"):
        assert k not in m
    assert not profiling.is_recording()


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_program_spans_lie_inside_the_benchmark_spans_on_the_card(
        name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import cells

    seen = []
    reader = harness.metric_reader

    def keep(metric):
        def read(t):
            seen.append(t)
            return reader(metric)(t)
        return read

    monkeypatch.setattr(harness, "metric_reader", keep)
    r = harness.run(cells.load(name), 4242424242, 0.0, True, "cuda:0",
                    time.perf_counter())
    assert r["correct"], r["checks"]
    t = seen[0]
    spans = program_spans.aligned(t)
    pairs = {"tfq.set_a": "bench.set_a", "tfq.solve.": "bench.solve",
             "tfq.get_x": "bench.get_x"}
    for prefix, bench in pairs.items():
        mine = sorted((s.start_us, s.end_us) for s in
                      program_spans.calls(spans, prefix).values())
        theirs = sorted((a, b) for n, a, b in t.spans if n == bench)
        assert len(mine) == len(theirs) == len(t.solves)
        for (a, b), (lo, hi) in zip(mine, theirs):
            assert lo - 50.0 <= a <= b <= hi + 50.0, (prefix, a, b, lo, hi)
    assert r["metrics"]["schedule_builds_per_set_a"]["value"] == 1.0
    for k in READERS:
        assert k in r["metrics"], k

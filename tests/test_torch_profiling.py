"""The port's measurement layer (``tfqmrgpu_tpu_torch.profiling``) against
the JAX package's ``tfqmrgpu_tpu.profiling`` on the CPU.

* ``trace``: a no-op without TFQ_TRACE; with it, ``Solver.solve`` opens a
  ``record_function`` range ``tfq.solve.<engine>`` that the CPU profiler
  records, and never touches NVTX on a CPU device.
* the span recorder: the tree of a point's spans on a CPU 'pairs' 'z'
  Solver (``tfq.set_a``, ``tfq.solve.pairs``, ``tfq.get_x`` and their
  children, one call id each, K1's schedule built once an A); nothing
  kept with it off; under a CPU profiler without TFQ_TRACE the spans are
  kept and the profiler sees none of them; the ring's bound.
* ``solver_roofline``: flops per iteration equal to JAX's exactly, and the
  bytes, the ceilings and the fractions equal to JAX's where both models
  call the vectors resident ('xla' and 'dense' in 'z' and 'c', the JAX
  CPU row) and at the golden class, where neither does; the A bytes of
  'pallas' and 'pairs' in 'c' are those of the panels K3 and K2 hold.
* ``DEVICE_PEAKS``: an unknown card raises; the comm model and the stream
  probe read the H100 row.
* ``calibrate_hbm`` and ``timed_solve`` on the CPU (host clock; a CPU rate
  is no device number).
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_random_problem
from test_torch_panel import _plans, _port
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import profiling as jprof
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.bsr import Bsr as JBsr
from tfqmrgpu_tpu_torch import dma_probe
from tfqmrgpu_tpu_torch import profiling as tprof
from tfqmrgpu_tpu_torch.errors import TfqmrgpuError
from tfqmrgpu_tpu_torch.parallel import comm_model

torch.set_num_threads(2)

CDTYPE = {"z": np.complex128, "c": np.complex64}


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    """Native f64 in the JAX 'xla' and 'dense' engines; no trace, no
    calibrated rate and the default residency budget in both packages."""
    monkeypatch.setenv("TFQ_XLA_OZ", "0")
    monkeypatch.setenv("TFQ_Z_OZAKI", "0")
    for k in ("TFQ_TRACE", "TFQ_HBM_GBPS", "TFQ_ROOFLINE_VMEM",
              "TFQ_PAIRS_COLGROUP", "TFQ_PAIRS_RTILE", "TFQ_PALLAS_RTILE"):
        monkeypatch.delenv(k, raising=False)


def _problem(precision, seed=0, mb=10, lm=4, ln=8, ncols=3):
    rng = np.random.default_rng(seed)
    return make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                               x_fill=1.0, dtype=CDTYPE[precision])


def _port_solver(precision, engine, seed=0, **kw):
    a, x, b = _problem(precision, seed, **kw)
    return tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                     device="cpu")


# ------------------------------------------------------------------ trace

@pytest.mark.parametrize("engine,precision", [
    ("xla", "z"), ("pairs", "z"), ("dense", "z"), ("pallas", "c"),
    ("pairs", "c")])
def test_trace_range_names_the_engine(monkeypatch, engine, precision):
    def refuse(*args):
        raise AssertionError("NVTX on a CPU device")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    s = _port_solver(precision, engine)
    for flag in ("1", None):
        if flag:
            monkeypatch.setenv("TFQ_TRACE", flag)
        else:
            monkeypatch.delenv("TFQ_TRACE")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            info = s.solve(tolerance=1e-5, max_iterations=50)
        names = [e.name for e in prof.events()]
        assert names.count(f"tfq.solve.{engine}") == (1 if flag else 0)
        assert info.return_status == 0


def test_trace_is_a_noop_without_the_variable(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function without TFQ_TRACE")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tprof.trace("tfq.solve.xla", "cpu"):
        pass
    monkeypatch.setenv("TFQ_TRACE", "0")
    with tprof.trace("tfq.solve.xla", "cpu"):
        pass


def test_start_and_stop_trace_write_the_range(monkeypatch, tmp_path):
    monkeypatch.setenv("TFQ_TRACE", "1")
    s = _port_solver("z", "xla")
    tprof.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        tprof.start_trace(str(tmp_path))
    s.solve(tolerance=1e-5, max_iterations=50)
    path = tprof.stop_trace()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tfq.solve.xla" for e in events)
    with pytest.raises(RuntimeError, match="no trace is running"):
        tprof.stop_trace()


# ------------------------------------------------------------------ spans

def _point(s, a):
    """One point of a contour: set A, solve, read X."""
    s.set_matrix("A", a.data)
    info = s.solve(tolerance=1e-5, max_iterations=50)
    s.get_matrix("X")
    return info


def _trees(spans) -> list:
    """Each top-level call, in order: (its name, {parent name: sorted
    child names})."""
    by_id = {sp.id: sp for sp in spans}
    out: dict = {sp.id: {} for sp in spans if sp.parent == 0}
    for sp in spans:
        if sp.parent:
            out[sp.call].setdefault(by_id[sp.parent].name, []).append(
                sp.name)
    return [(by_id[c].name, {p: sorted(k) for p, k in d.items()})
            for c, d in sorted(out.items(), key=lambda cd:
                               by_id[cd[0]].start_ns)]


def test_spans_of_a_point_on_the_pairs_engine():
    a, x, b = _problem("z")
    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    tprof.clear_spans()
    with tprof.recording():
        for _ in range(2):
            assert _point(s, _port(a)[0]).return_status == 0
    spans = tprof.spans()
    tops = [sp for sp in spans if sp.parent == 0]
    assert [sp.name for sp in tops] == [
        "tfq.set_a", "tfq.solve.pairs", "tfq.get_x"] * 2
    assert all(sp.call == sp.id for sp in tops)
    assert _trees(spans) == [
        ("tfq.set_a", {"tfq.set_a": ["multiply", "planes", "refill",
                                     "upload"],
                       "multiply": ["copies", "pair_table", "pair_y",
                                    "schedule", "schedule_upload"]}),
        ("tfq.solve.pairs", {"tfq.solve.pairs": ["finish", "prepare"]}),
        ("tfq.get_x", {"tfq.get_x": ["copy", "unpack"]})] * 2
    by_id = {sp.id: sp for sp in spans}
    for sp in spans:
        assert sp.start_ns <= sp.end_ns
        if sp.parent:
            up = by_id[sp.parent]
            assert sp.call == up.call
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns
    for top in tops:
        if top.name == "tfq.set_a":
            assert [sp.name for sp in spans if sp.call == top.id].count(
                "schedule") == 1
    # the CPU keeps no loop graph, so no set A refills one
    assert [sp.attrs for sp in spans if sp.name == "refill"] == [
        {"hit": False}] * 2
    tprof.clear_spans()
    assert tprof.spans() == []


@pytest.mark.parametrize("lm,ln", [(4, 8), (64, 64)])
def test_the_schedule_span_carries_k1s_tile_figures(lm, ln):
    """A set A records K1's schedule as the `schedule` span's attributes:
    the warp grid, tiles, steps, staged bytes and the plan's pairs, equal
    to the fields of the ``TileSchedule`` the multiply runs."""
    a, x, b = _problem("z", mb=6 if lm == 64 else 10, lm=lm, ln=ln)
    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    tprof.clear_spans()
    with tprof.recording():
        s.set_matrix("A", _port(a)[0].data)
    (span,) = [sp for sp in tprof.spans() if sp.name == "schedule"]
    sched = s._multiply.schedule
    assert span.attrs == {
        "grid": (sched.warps_m, sched.warps_n), "tiles": sched.ntiles,
        "steps": sched.nsteps, "staged_bytes": sched.staged_bytes,
        "pairs": int(s.plan.pairs.shape[0])}
    assert sched.ntiles > 0 and sched.nsteps > 0
    if lm == 64:                  # the one grid: a Y block a tile
        assert span.attrs["grid"] == (2, 2)
        assert span.attrs["staged_bytes"] == 2 * 16 * 64 * 64 * span.attrs[
            "pairs"]
    tprof.clear_spans()


def test_nothing_is_kept_with_the_recorder_off():
    a, x, b = _problem("z")
    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    tprof.clear_spans()
    assert not tprof.is_recording()
    assert _point(s, _port(a)[0]).return_status == 0
    assert tprof.spans() == []
    # off, a span is the one shared no-op context: nothing is made
    assert tprof.trace("a") is tprof.trace("b", "cpu")
    assert tprof.add_span("a", 0, 1) is None
    with tprof.trace("a") as span:
        assert span is None


@pytest.mark.parametrize("engine,precision", [
    ("pairs", "z"), ("dense", "z"), ("pallas", "c"), ("pairs", "c")])
def test_a_profiler_session_keeps_spans_but_sees_none(engine, precision):
    a, x, b = _problem(precision)
    s = tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                  device="cpu")
    tprof.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tprof.is_recording()
        assert _point(s, _port(a)[0]).return_status == 0
    assert not tprof.is_recording()
    names = {sp.name for sp in tprof.spans()}
    assert {"tfq.set_a", f"tfq.solve.{engine}", "tfq.get_x", "planes",
            "upload", "multiply", "refill", "prepare", "finish", "copy",
            "unpack"} <= names
    seen = {e.name for e in prof.events()}
    assert not [n for n in seen if n.startswith("tfq.")]
    assert not names & seen
    tprof.clear_spans()


def test_the_ring_keeps_the_newest_spans():
    tprof.clear_spans()
    with tprof.recording():
        for i in range(tprof.SPAN_RING + 10):
            with tprof.trace(f"s{i}"):
                pass
        outer = tprof.add_span("outer", 5, 9)
        inner = tprof.add_span("inner", 6, 7, parent=outer, device_ms=0.5)
    spans = tprof.spans()
    assert len(spans) == tprof.SPAN_RING
    assert spans[0].name == "s12" and spans[-3].name == f"s{tprof.SPAN_RING + 9}"
    assert (outer.parent, outer.call) == (0, outer.id)
    assert (inner.parent, inner.call, inner.attrs) == (
        outer.id, outer.id, {"device_ms": 0.5})
    tprof.clear_spans()


def test_threads_keep_their_own_trees():
    """recording() holds for the thread that opens it, and each recording
    thread nests its spans under its own; the ring and the ids are
    shared."""
    import sys
    import threading

    tprof.clear_spans()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k, record):
            with tprof.recording() if record else contextlib.nullcontext():
                for i in range(200):
                    with tprof.trace(f"t{k}"):
                        with tprof.trace(f"t{k}.child"):
                            pass

        threads = [threading.Thread(target=work, args=(k, k < 6))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = tprof.spans()
    assert len(spans) == 6 * 200 * 2 == len({sp.id for sp in spans})
    by_id = {sp.id: sp for sp in spans}
    for sp in spans:
        if sp.name.endswith(".child"):
            assert by_id[sp.parent].name == sp.name[:-len(".child")]
        else:
            assert sp.parent == 0 and sp.name in {f"t{k}" for k in range(6)}
    tprof.clear_spans()


def test_trace_keeps_the_tree_under_tfq_trace(monkeypatch):
    """Under TFQ_TRACE each span is also a profiler range, children inside
    their parent."""
    monkeypatch.setenv("TFQ_TRACE", "1")
    a, x, b = _problem("z")
    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    tprof.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _point(s, _port(a)[0])
    kept = sorted(sp.name for sp in tprof.spans())
    ranges = sorted(e.name for e in prof.events() if e.name in set(kept))
    assert ranges == kept
    tprof.clear_spans()


# --------------------------------------------------------------- roofline

def _assert_same_roofline(got, want):
    for k in ("flops_per_iteration", "bytes_per_iteration", "device_kind",
              "peak_tflops", "peak_gbps", "compute_bound", "light_speed_s",
              "vectors_resident", "measured_s", "fraction_of_light",
              "fraction_of_sheet_light", "nnz_mac_per_s"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("engine", ["xla", "dense"])
@pytest.mark.parametrize("precision", ["z", "c"])
def test_roofline_matches_jax_resident(engine, precision):
    a, x, b = _problem(precision, seed=1)
    js = jsolver.Solver(a, x, b, precision=precision, engine=engine)
    _, tp = _plans(a, x, b, 4, 8)
    ts = tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                   plan=tp, device="cpu")
    for measured in (None, 2.5e-3):
        got = tprof.solver_roofline(ts, measured)
        _assert_same_roofline(got, jprof.solver_roofline(js, measured))
        assert got.vectors_resident and got.device_kind == "cpu"
    rsize = 8 if precision == "z" else 4
    nr = tp.nrows * 4
    a_bytes = (2 * nr * nr if engine == "dense"
               else tp.nnzb_a * 2 * 4 * 4) * rsize
    assert got.bytes_per_iteration == 2 * a_bytes


def _golden_jax_port():
    from chip_smoke import golden_class_patterns

    ports = golden_class_patterns()
    jaxs = [JBsr(m.nrows, m.ncols, m.rowptr, m.colind, None, m.name)
            for m in ports]
    return jaxs, ports


def test_roofline_matches_jax_golden_class_not_resident(monkeypatch):
    """Pattern only (no data, nothing solved): the golden class's 'z'
    vectors (73.7 MB) are resident in neither model, so both count the 15
    vector passes; on the H100 row the iteration is compute-bound at the
    FP64 tensor-core rate."""
    (ja, jx, jb), (pa, px, pb) = _golden_jax_port()
    js = jsolver.Solver(ja, jx, jb, precision="z", engine="xla", lm=32,
                        ln=32)
    want = jprof.solver_roofline(js, 9e-3)
    ts = tt.Solver(pa, px, pb, precision="z", engine="xla", lm=32, ln=32,
                   device="cpu")
    got = tprof.solver_roofline(ts, 9e-3)
    _assert_same_roofline(got, want)
    nvec = 4496 * 2 * 32 * 32 * 8
    assert not got.vectors_resident
    assert got.bytes_per_iteration == 2 * 3091 * 2 * 32 * 32 * 8 + 15 * nvec
    # the same iteration on the H100's data sheet: K1's block list
    pairs = tt.Solver(pa, px, pb, precision="z", engine="pairs", lm=32,
                      ln=32, device="cpu")
    monkeypatch.setattr(tprof, "device_kind", lambda device: tprof.H100)
    h = tprof.solver_roofline(pairs)
    assert h.device_kind == tprof.H100 and h.compute_bound
    assert h.bytes_per_iteration == got.bytes_per_iteration
    assert h.light_speed_s == pytest.approx(
        got.flops_per_iteration / 67e12)
    assert 0.38e-3 < h.light_speed_s < 0.40e-3


@pytest.mark.parametrize("engine,group", [("pallas", None), ("pairs", "1"),
                                          ("pairs", "2")])
def test_a_bytes_are_the_panels_the_kernels_hold(monkeypatch, engine, group):
    if group:
        monkeypatch.setenv("TFQ_PAIRS_COLGROUP", group)
    s = _port_solver("c", engine, seed=2, ncols=4)
    r = tprof.solver_roofline(s)
    mult = s._multiply
    panels = mult.a_fused if engine == "pallas" else mult.a_panels
    assert r.vectors_resident
    assert r.bytes_per_iteration == 2 * panels.numel() * 4
    if engine == "pairs":
        assert (s._gp.group_size if s._gp else 1) == int(group)
        # one vector is the fused panel: G lane blocks a cell
        assert s._v3.shape == (s._pp_plan.n_slots * 4, 2 * s._pp_plan.ln)


def test_roofline_takes_the_calibrated_rate(monkeypatch):
    s = _port_solver("c", "xla", seed=3)
    sheet = tprof.solver_roofline(s, 1e-3)
    monkeypatch.setenv("TFQ_HBM_GBPS", "1.0")
    slow = tprof.solver_roofline(s, 1e-3)
    assert slow.peak_gbps == 1.0 and not slow.compute_bound
    assert slow.light_speed_s == pytest.approx(
        slow.bytes_per_iteration / 1e9)
    assert slow.fraction_of_sheet_light == sheet.fraction_of_sheet_light
    assert slow.fraction_of_light > slow.fraction_of_sheet_light


# ------------------------------------------------------------------ peaks

def test_device_peaks_raise_for_an_unknown_card():
    with pytest.raises(TfqmrgpuError, match="NVIDIA A100-SXM4-80GB"):
        tprof.device_peaks("NVIDIA A100-SXM4-80GB")
    s = _port_solver("z", "xla")
    s.device = torch.device("meta")
    with pytest.raises(TfqmrgpuError, match="'meta'"):
        tprof.solver_roofline(s)


def test_h100_row_is_the_one_source_of_the_sheet_rates():
    row = tprof.DEVICE_PEAKS[tprof.H100]
    assert row == dict(fp64_tflops=67.0, fp32_tflops=67.0, bf16_tflops=989.0,
                       int8_tops=1979.0, hbm_gbps=3350.0, l2_mb=50)
    assert comm_model.HBM_BYTES_PER_S == dma_probe.HBM_BYTES_PER_S == 3.35e12
    assert comm_model.FP32_FLOPS_PER_S == 67e12
    assert tprof.DEVICE_PEAKS["cpu"]["fp64_tflops"] == (
        jprof.DEVICE_PEAKS["cpu"]["bf16_tflops"] / 40)
    assert tprof.DEVICE_PEAKS["cpu"]["bf16_tflops"] == (
        jprof.DEVICE_PEAKS["cpu"]["bf16_tflops"])


# ------------------------------------------------------ rate and timing

def test_calibrate_hbm_sets_the_rate(monkeypatch):
    monkeypatch.setenv("TFQ_HBM_GBPS", "1.0")
    gbps = tprof.calibrate_hbm(size_mb=4, nrep=2, device="cpu")
    assert gbps > 0.0
    assert os.environ["TFQ_HBM_GBPS"] == f"{gbps:.1f}"


def test_timed_solve_repeats_the_plain_solve():
    s = _port_solver("z", "pairs", seed=4)
    want = s.solve(tolerance=1e-8, max_iterations=200)
    info, best, r = tprof.timed_solve(s, tolerance=1e-8, max_iterations=200,
                                      repeats=3)
    assert info.return_status == want.return_status == 0
    assert info.iterations_needed == want.iterations_needed
    assert best > 0.0
    assert r.measured_s == best / info.iterations_needed
    assert r.fraction_of_light == r.light_speed_s / r.measured_s

"""The port's measurement layer (``tfqmrgpu_tpu_torch.profiling``) against
the JAX package's ``tfqmrgpu_tpu.profiling`` on the CPU.

* ``trace``: a no-op without TFQ_TRACE; with it, ``Solver.solve`` opens a
  ``record_function`` range ``tfq.solve.<engine>`` that the CPU profiler
  records, and never touches NVTX on a CPU device.
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

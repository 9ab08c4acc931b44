"""The port's mixed precision 'm' against the JAX package's on the CPU.

* ``refine_mixed`` over a 'c' Solver with the JAX plan and v3 handed over,
  in each vector layout ('xla' block lists, 'dense' panels, packed
  'pairs'): the same c-stage iterations, refinement rounds and total
  iterations, X to 1e-8 relative.  The JAX side runs its float64 products
  in plain float64 (TFQ_XLA_OZ=0, TFQ_Z_OZAKI=0) and its packed engine as
  tests/test_torch_pairpack.py does.
* ``bsrsv_m`` one-call: SUCCESS and a dense float64 residual over X's
  pattern below 1e-8.
* FD rtb=6.75 at 1e-9: the one-call reaches the generator's reference, and
  with JAX's v3 handed over both packages converge to the same X.
* A system where the float32 corrections stall reaches the 'z' fallback.
"""

import functools

import numpy as np
import pytest
import torch

import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch import solver as tsolver
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.generator import generate_fd_problem
from conftest import dense_from_bsr, make_random_problem
from test_torch_panel import _port
import tfqmrgpu_tpu.refine as jrefine
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.bsr import Bsr as JBsr

torch.set_num_threads(2)

PAIRS_ENV = (("TFQ_SOLVER_SUPER", "0"), ("TFQ_PAIRS_RESIDENT", "1"),
             ("TFQ_PAIRS_TILEPIPE", "1"))


def _pattern_residual(a, x, b, xc, lm, ln):
    """|A X - B| / |B| over X's pattern, where tfQMR solves the system."""
    mask = dense_from_bsr(x.with_data(np.ones((x.nnzb, lm, ln))), lm, ln) != 0
    r = dense_from_bsr(a, lm, lm) @ dense_from_bsr(x.with_data(xc), lm, ln) \
        - dense_from_bsr(b, lm, ln)
    return np.linalg.norm(r[mask]) / np.linalg.norm(dense_from_bsr(b, lm, ln))


def _refine_both(monkeypatch, a, x, b, engine, tol, maxit):
    """The c stage and ``refine_mixed`` through both packages, the JAX plan
    and v3 handed to the port.  Returns (JAX, port) tuples of (c-stage
    info, refined X, info, converged, rounds)."""
    monkeypatch.setenv("TFQ_XLA_OZ", "0")
    monkeypatch.setenv("TFQ_Z_OZAKI", "0")
    if engine == "pairs":
        for k, v in PAIRS_ENV + (("TFQ_PAIRS_COLGROUP", "1"),):
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(tsolver, "choose_group_size", lambda *a, **k: 1)
    rounds = []
    loop = jrefine.refinement_loop

    def counted(**kw):
        res = loop(**kw)
        rounds.append(res["rounds"])
        return res

    monkeypatch.setattr(jrefine, "refinement_loop", counted)
    maxit_c = min(maxit, max(150, maxit // 4))
    ctol = max(1e-4, tol)
    js = jsolver.Solver(*(JBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data,
                               m.name) for m in (a, x, b)),
                        precision="c", engine=engine)
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, js.lm, js.ln)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="c", engine=engine, plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    assert ts.engine == js.engine == engine
    a64 = (np.ascontiguousarray(a.data.real, np.float64),
           np.ascontiguousarray(a.data.imag, np.float64))
    out = []
    for s, mod in ((js, jsolver), (ts, tsolver)):
        info_c = s.solve(tolerance=ctol, max_iterations=maxit_c)
        bx64 = mod._scatter_to_x(s.plan, b.data, s.lm, s.ln)
        xm, info, conv = mod.refine_mixed(s, *a64, bx64, tol, maxit, info_c)
        out.append((info_c, xm, info, conv))
    jrounds = rounds[0]
    (jc, jx, ji, jconv), (tc, tx, ti, tconv) = out
    return (jc, jx, ji, jconv, jrounds), (tc, tx, ti, tconv,
                                          ti.refinement["rounds"])


def _assert_same_refinement(want, got, tol):
    jc, jx, ji, jconv, jrounds = want
    tc, tx, ti, tconv, trounds = got
    assert tc.iterations_needed == jc.iterations_needed
    assert (trounds, ti.iterations_needed, tconv) == (
        jrounds, ji.iterations_needed, jconv)
    assert ti.return_status == ji.return_status
    assert tx.dtype == np.complex128
    assert np.max(np.abs(tx - jx)) <= 1e-8 * np.max(np.abs(jx))
    # both end below the tolerance (or both above it, a stall)
    assert (ti.residuum_reached <= tol) == (ji.residuum_reached <= tol)
    # the JAX accounting: c stage + refinement rounds and iterations
    assert ti.flops_performed == pytest.approx(ji.flops_performed)


@pytest.mark.parametrize("engine", ["xla", "dense", "pairs"])
def test_refine_mixed_matches_jax(monkeypatch, engine):
    """The packed layouts of the two packages sum float32 in another order
    (K2's plain version against the TPU kernel run in interpret mode), which
    can move a stop that lies within rounding of its target by an
    iteration; this system's stops lie clear of theirs in all three
    layouts."""
    a, x, b = make_random_problem(np.random.default_rng(32), mb=12, lm=4,
                                  ln=4, ncols=3, x_fill=0.7)
    want, got = _refine_both(monkeypatch, a, x, b, engine, 1e-10, 500)
    _assert_same_refinement(want, got, 1e-10)
    assert got[3] and got[4] >= 1          # converged, after a round
    assert _pattern_residual(a, x, b, got[1], 4, 4) < 1e-8


def test_bsrsv_m_reaches_f64_residual():
    lm = ln = 4
    a, x, b = make_random_problem(np.random.default_rng(42), mb=10, lm=lm,
                                  ln=ln, ncols=3, x_fill=1.0)
    xs, info = tt.bsrsv_m(*_port(a, x, b), tolerance=1e-10,
                          max_iterations=500, device="cpu")
    assert info.return_status == Status.SUCCESS
    assert info.residuum_reached <= 1e-10
    assert not info.refinement["fallback"]
    assert info.refinement["c_iterations"] < info.iterations_needed
    assert _pattern_residual(a, x, b, xs.data, lm, ln) < 1e-8
    # 'm' is no Solver precision; solve(precision='m') is the one-call
    xs2, info2 = tt.solve(*_port(a, x, b), precision="m", tolerance=1e-10,
                          max_iterations=500, device="cpu")
    assert info2.iterations_needed == info.iterations_needed
    assert np.array_equal(xs2.data, xs.data)


def test_fd_bsrsv_m_reaches_reference_with_jax_v3(monkeypatch):
    """FD rtb=6.75 at 1e-9.  The float32 c stage of this system ends when
    every column's stagnation flag (-3) is set, at an iteration that the
    float32 rounding of the product decides, so even with JAX's v3 the two
    packages' counts differ (measured here: JAX 118 c-iterations + 60 over
    3 correction rounds, the port 146 + 302 over 3; XLA's and torch's
    float32 dense products sum in another order).  Both must reach 1e-9
    without the 'z' fallback and agree on X."""
    prob = generate_fd_problem(rtb=6.75, reference=True)
    a, b = prob.a_with_data(), prob.b_with_data()
    ref = prob.x_reference.astype(np.float64)
    xs, info = tt.bsrsv_m(a, prob.x, b, tolerance=1e-9, device="cpu")
    assert info.return_status == Status.SUCCESS
    assert info.residuum_reached <= 1e-9
    assert not info.refinement["fallback"]
    assert np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref)) < 1e-5
    want, got = _refine_both(monkeypatch, a, prob.x, b, "dense", 1e-9, 999)
    jc, jx, ji, jconv, jrounds = want
    tc, tx, ti, tconv, trounds = got
    assert jconv and tconv
    assert max(ji.iterations_needed, ti.iterations_needed) < 999
    assert ti.residuum_reached <= 1e-9 and ji.residuum_reached <= 1e-9
    assert np.max(np.abs(tx - jx)) <= 1e-7 * np.max(np.abs(jx))
    assert np.max(np.abs(tx - ref)) / np.max(np.abs(ref)) < 1e-5


def test_stalled_refinement_falls_back_to_z():
    """Rows of A scaled over six decades: the float32 corrections stall
    (the ratio falls less than 4x a round) with budget left, and the
    complex128 solve restarted from the refined iterate finishes."""
    lm = ln = 4
    a, x, b = make_random_problem(np.random.default_rng(5), mb=10, lm=lm,
                                  ln=ln, ncols=3, x_fill=1.0)
    d = np.logspace(0, 6, a.nrows)
    a = a.with_data(a.data * d[a.row_of()][:, None, None])
    xs, info = tt.bsrsv_m(*_port(a, x, b), tolerance=1e-10,
                          max_iterations=1200, device="cpu")
    r = info.refinement
    assert r["fallback"]
    assert info.return_status == Status.SUCCESS
    assert info.residuum_reached <= 1e-10
    assert info.iterations_needed <= 1200
    assert info.engine == "dense"
    assert _pattern_residual(a, x, b, xs.data, lm, ln) < 1e-8


@pytest.mark.parametrize("engine,fallback_engine", [
    ("pallas", "dense"), ("pairs", "pairs"), ("xla", "xla")])
def test_fallback_engine(monkeypatch, engine, fallback_engine):
    """The 'z' fallback maps only 'pallas' (float32-only) to 'dense'; an
    explicit 'pairs' stays (K1 runs 'z' at every block size).  One round of
    refinement leaves the iterate unconverged, which forces the fallback."""
    monkeypatch.setattr(tsolver, "refine_mixed",
                        functools.partial(tsolver.refine_mixed, max_rounds=1))
    lm = ln = 8
    a, x, b = make_random_problem(np.random.default_rng(7), mb=10, lm=lm,
                                  ln=ln, ncols=2, x_fill=1.0)
    xs, info = tt.bsrsv_m(*_port(a, x, b), tolerance=1e-10, engine=engine,
                          max_iterations=500, device="cpu")
    assert info.refinement["c_engine"] == engine
    assert info.refinement["fallback"] and info.refinement["rounds"] == 1
    assert info.engine == fallback_engine
    assert info.return_status == Status.SUCCESS
    assert _pattern_residual(a, x, b, xs.data, lm, ln) < 1e-8

"""The port's solve against the JAX package's on the CPU: the same plan, the
same shadow vector v3 and the same inputs must give the same iteration
count and statuses, and X to 1e-10 relative.  The JAX side runs its
block-list engine in plain float64 (TFQ_XLA_OZ=0), not the Ozaki slices."""

import numpy as np
import pytest
import torch

from conftest import dense_from_bsr, make_random_problem
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.errors import Status

torch.set_num_threads(2)


def _port(*bsrs):
    return [TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
            for m in bsrs]


def _jax_and_port(monkeypatch, a, x, b, tol, maxit, x0=None,
                  rhs_trivial=False):
    monkeypatch.setenv("TFQ_XLA_OZ", "0")
    js = jsolver.Solver(a, x, b, precision="z", engine="xla")
    if x0 is not None:
        js.set_matrix("X", x0)
    jinfo = js.solve(tolerance=tol, max_iterations=maxit,
                     rhs_trivial=rhs_trivial)
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, js.lm, js.ln)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="z", engine="pairs", plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    assert ts.engine == "pairs"
    if x0 is not None:
        ts.set_matrix("X", x0)
    tinfo = ts.solve(tolerance=tol, max_iterations=maxit,
                     rhs_trivial=rhs_trivial)
    return js, jinfo, ts, tinfo


def _pattern_residual(a, x, b, xc, lm, ln):
    """|A X - B| / |B| over X's pattern, where tfQMR solves the system."""
    ones = x.with_data(np.ones((x.nnzb, lm, ln)))
    mask = dense_from_bsr(ones, lm, ln) != 0
    r = dense_from_bsr(a, lm, lm) @ dense_from_bsr(x.with_data(xc), lm, ln) \
        - dense_from_bsr(b, lm, ln)
    return np.linalg.norm(r[mask]) / np.linalg.norm(dense_from_bsr(b, lm, ln))


def _assert_same_solve(js, jinfo, ts, tinfo):
    assert tinfo.iterations_needed == jinfo.iterations_needed
    assert tinfo.return_status == jinfo.return_status
    assert np.array_equal(tinfo.rhs_status, np.asarray(jinfo.rhs_status))
    want = js.get_matrix("X")
    got = ts.get_matrix("X")
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    assert tinfo.flops_performed == pytest.approx(jinfo.flops_performed)


@pytest.mark.parametrize("seed,mb,lm,ln,ncols,tol", [
    (0, 12, 4, 8, 3, 1e-10),
    (1, 16, 8, 8, 2, 1e-9),
    (2, 10, 8, 10, 4, 1e-12),
])
def test_slice_matches_jax(monkeypatch, seed, mb, lm, ln, ncols, tol):
    a, x, b = make_random_problem(np.random.default_rng(seed), mb=mb, lm=lm,
                                  ln=ln, ncols=ncols)
    js, jinfo, ts, tinfo = _jax_and_port(monkeypatch, a, x, b, tol, 200)
    assert tinfo.return_status == Status.SUCCESS
    _assert_same_solve(js, jinfo, ts, tinfo)
    # independent check on the dense operator
    assert _pattern_residual(a, x, b, ts.get_matrix("X"), lm, ln) < 1e2 * tol


def test_initial_guess_and_iteration_cap_match_jax(monkeypatch):
    a, x, b = make_random_problem(np.random.default_rng(8), mb=12, lm=4,
                                  ln=4, ncols=2)
    rng = np.random.default_rng(9)
    x0 = 0.01 * (rng.standard_normal((x.nnzb, 4, 4))
                 + 1j * rng.standard_normal((x.nnzb, 4, 4)))
    # a cap of 3 iterations stops short of 1e-13: MAX_ITERATIONS on both
    js, jinfo, ts, tinfo = _jax_and_port(monkeypatch, a, x, b, 1e-13, 3, x0)
    assert tinfo.return_status == Status.MAX_ITERATIONS
    _assert_same_solve(js, jinfo, ts, tinfo)


def test_trivial_rhs_matches_jax(monkeypatch):
    a, x, b = make_random_problem(np.random.default_rng(10), mb=10, lm=4,
                                  ln=8, ncols=2, x_fill=1.0)
    js, jinfo, ts, tinfo = _jax_and_port(monkeypatch, a, x, b, 1e-10, 200,
                                         rhs_trivial=True)
    assert tinfo.return_status == Status.SUCCESS
    _assert_same_solve(js, jinfo, ts, tinfo)


def test_fd_bsrsv_z_reaches_dense_reference():
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    prob = generate_fd_problem(rtb=6.75, reference=True)
    xs, info = tt.bsrsv_z(prob.a_with_data(), prob.x, prob.b_with_data(),
                          tolerance=1e-9, max_iterations=2000,
                          engine="pairs", device="cpu")
    assert info.engine == "pairs"
    assert info.return_status == Status.SUCCESS
    assert info.residuum_reached <= 1e-9
    ref = prob.x_reference.astype(np.float64)
    assert np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("engine", ["pairs", "xla"])
def test_complex64_solve_and_layouts(engine):
    """'c' through the packed 'pairs' engine and the plain block list."""
    a, x, b = make_random_problem(np.random.default_rng(4), mb=10, lm=4,
                                  ln=8, ncols=2, dtype=np.complex64)
    s = tt.Solver(*_port(a, x, b), precision="c", engine=engine,
                  device="cpu")
    assert (s._pp_plan is not None) == (engine == "pairs")
    info = s.solve(tolerance=1e-5, max_iterations=200)
    assert info.engine == engine
    assert info.return_status == Status.SUCCESS
    xc = s.get_matrix("X")
    assert xc.dtype == np.complex64
    assert _pattern_residual(a, x, b, xc, 4, 8) < 1e-4
    # reference layouts and transpositions round-trip through get_matrix
    riri = s.get_matrix("X", layout=0x55)
    assert np.array_equal(riri[..., 0], xc.real)
    assert np.array_equal(s.get_matrix("X", trans="h"),
                          np.conj(np.swapaxes(xc, 1, 2)))


@pytest.mark.parametrize("kw,code", [
    (dict(engine="pallas"), Status.PRECISION_MISSMATCH),
    (dict(engine="ell"), Status.NO_IMPLEMENTATION),
    (dict(precision="m"), Status.PRECISION_MISSMATCH),
    (dict(precision="q"), Status.PRECISION_MISSMATCH),
])
def test_unported_options_raise(kw, code):
    a, x, b = make_random_problem(np.random.default_rng(6), mb=6, lm=4, ln=4,
                                  ncols=1)
    with pytest.raises(tt.TfqmrgpuError) as e:
        tt.Solver(*_port(a, x, b), device="cpu", **kw)
    assert e.value.code == code


def _group_inputs(s):
    """The arguments ``choose_group_size`` gets from a solver's plan."""
    p = s.plan
    pairs = p.pairs.numpy().astype(np.int64)
    pair_y = np.repeat(np.arange(p.nnzb_x), np.diff(p.starts.numpy()))
    row_of = np.repeat(np.arange(p.nrows), np.diff(p.rowptr_x))
    return (pairs, pair_y, p.nnzb_x, s.lm, s.ln, row_of,
            p.colindx.numpy().astype(np.int64), p.ncols)


@pytest.mark.parametrize("where", ["grouping", "model"])
def test_group_size_errors_fall_back_to_ungrouped(monkeypatch, where):
    """A G whose grouping raises is skipped, and a model that raises means
    G = 1, as in the JAX package: the Solver builds ungrouped and solves as
    the ungrouped one does."""
    from tfqmrgpu_tpu_torch import solver as tsolver
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    a, x, b = _port(*make_random_problem(
        np.random.default_rng(21), mb=12, lm=4, ln=4, ncols=4, x_fill=1.0,
        dtype=np.complex64))
    grouped = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    assert grouped._gp is not None         # the rule groups this pattern
    picked = tsolver.choose_group_size(*_group_inputs(grouped))
    assert picked > 1

    def refuse(*args, **kw):
        raise ValueError("this pattern does not group")

    if where == "grouping":
        monkeypatch.setattr(pp, "_choose_groups", refuse)
        pairs, pair_y, nnzb, lm, ln, row_of, cols, _ = _group_inputs(grouped)
        best, ests = pp.auto_group_size(pairs[:, 0], pairs[:, 1], pair_y,
                                        nnzb, lm, ln, row_of=row_of,
                                        col_of=cols)
        assert best == 1 and list(ests) == [1]
    else:
        monkeypatch.setattr(pp, "auto_group_size", refuse)
    assert tsolver.choose_group_size(*_group_inputs(grouped)) == 1
    s = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    assert s._gp is None and s._pp_plan is not None
    monkeypatch.undo()
    monkeypatch.setattr(tsolver, "choose_group_size", lambda *a, **k: 1)
    ref = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    infos = [v.solve(tolerance=1e-5, max_iterations=200) for v in (s, ref)]
    assert infos[0].return_status == Status.SUCCESS
    assert infos[0].iterations_needed == infos[1].iterations_needed
    assert np.array_equal(s.get_matrix("X"), ref.get_matrix("X"))


def test_pair_pack_failure_falls_back_under_auto(monkeypatch):
    """A failing packed 'pairs' pack sends 'auto' to 'xla', as the JAX
    solver does; an explicit engine='pairs' raises a TfqmrgpuError."""
    from tfqmrgpu_tpu_torch import solver as tsolver
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    a, x, b = _port(*make_random_problem(
        np.random.default_rng(22), mb=24, lm=4, ln=4, ncols=2,
        dtype=np.complex64))
    # LM 4 rules out the row tiles, and no dense limit: 'auto' takes 'pairs'
    monkeypatch.setattr(tsolver, "DENSE_A_BYTE_LIMIT", 0)
    assert tt.Solver(a, x, b, precision="c", device="cpu").engine == "pairs"

    def refuse(*args, **kw):
        raise ValueError("no recoverable locality")

    monkeypatch.setattr(pp, "pack_pair_plan", refuse)
    s = tt.Solver(a, x, b, precision="c", device="cpu")
    assert s.engine == "xla" and s._pp_plan is None
    info = s.solve(tolerance=1e-5, max_iterations=200)
    ref = tt.Solver(a, x, b, precision="c", engine="xla", device="cpu")
    rinfo = ref.solve(tolerance=1e-5, max_iterations=200)
    assert info.engine == "xla" and info.return_status == Status.SUCCESS
    assert info.iterations_needed == rinfo.iterations_needed
    assert np.array_equal(s.get_matrix("X"), ref.get_matrix("X"))
    with pytest.raises(tt.TfqmrgpuError) as e:
        tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    assert e.value.code == Status.UNDOCUMENTED_ERROR
    assert "no recoverable locality" in str(e.value)

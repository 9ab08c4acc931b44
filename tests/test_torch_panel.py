"""The port's panel layout, dense engine and 'auto' rule against the JAX
package's on the CPU.  The JAX side's 'z' dense product runs in plain
float64 (TFQ_Z_OZAKI=0), not the Ozaki slices, so both sides compute the
same numbers up to the order of float64 sums: the dense product is held to
1e-12 and solved X to 1e-10 relative, with the same iteration counts."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import dense_from_bsr, make_random_problem
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.ops import panel as jpanel
from tfqmrgpu_tpu.plan import create_plan as jcreate_plan
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch import solver as tsolver
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import panel as tpanel

torch.set_num_threads(2)


def _port(*bsrs):
    return [TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
            for m in bsrs]


def _plans(a, x, b, lm, ln):
    jp = jcreate_plan(a, x, b, cache=False)
    jp.lm, jp.ln = lm, ln
    tp = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    tp.lm, tp.ln = lm, ln
    return jp, tp


def jax_and_port(monkeypatch, a, x, b, *, engine, precision, tol, maxit,
                 x0=None, rhs_trivial=False):
    """The same solve through both packages: the JAX plan and v3 handed to
    the port, the port on the CPU."""
    monkeypatch.setenv("TFQ_Z_OZAKI", "0")
    js = jsolver.Solver(a, x, b, precision=precision, engine=engine)
    if x0 is not None:
        js.set_matrix("X", x0)
    jinfo = js.solve(tolerance=tol, max_iterations=maxit,
                     rhs_trivial=rhs_trivial)
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, js.lm, js.ln)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                   plan=plan, v3=tuple(np.asarray(v) for v in v3),
                   device="cpu")
    assert ts.engine == js.engine == engine
    if x0 is not None:
        ts.set_matrix("X", x0)
    tinfo = ts.solve(tolerance=tol, max_iterations=maxit,
                     rhs_trivial=rhs_trivial)
    return js, jinfo, ts, tinfo


def assert_same_solve(js, jinfo, ts, tinfo, rtol):
    assert tinfo.iterations_needed == jinfo.iterations_needed
    assert tinfo.return_status == jinfo.return_status
    assert np.array_equal(tinfo.rhs_status, np.asarray(jinfo.rhs_status))
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))
    assert tinfo.flops_performed == pytest.approx(jinfo.flops_performed)


@pytest.mark.parametrize("seed,mb,lm,ln,ncols,x_fill", [
    (0, 12, 4, 8, 3, 0.6), (1, 9, 8, 8, 2, 1.0), (2, 16, 4, 5, 4, 0.3),
])
def test_panel_layout_identical(seed, mb, lm, ln, ncols, x_fill):
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                                  x_fill=x_fill)
    jp, tp = _plans(a, x, b, lm, ln)
    jl, tl = jpanel.PanelLayout.from_plan(jp), tpanel.PanelLayout.from_plan(tp)
    for k in ("mb", "lm", "ncc", "ln"):
        assert getattr(tl, k) == getattr(jl, k), k
    for k in ("x_rows", "x_cols", "b_rows", "b_cols", "mask"):
        got, want = getattr(tl, k), getattr(jl, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    blocks = rng.standard_normal((tp.nnzb_x, lm, ln))
    panel = tl.pack_x(blocks)
    assert np.array_equal(panel, jl.pack_x(blocks))
    assert np.array_equal(tl.unpack_x(panel), blocks)
    bb = rng.standard_normal((tp.nnzb_b, lm, ln))
    assert np.array_equal(tl.pack_b(bb), jl.pack_b(bb))
    assert np.array_equal(tl.unit_b_blocks(np.float32),
                          jl.unit_b_blocks(np.float32))
    are, aim = a.data.real.copy(), a.data.imag.copy()
    for got, want in zip(tl.densify_a(tp, are, aim),
                         jl.densify_a(jp, are, aim)):
        assert np.array_equal(got, want)


def test_dense_multiply_matches_jax(monkeypatch):
    monkeypatch.setenv("TFQ_Z_OZAKI", "0")
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3)
    jp, tp = _plans(a, x, b, lm, ln)
    lay = tpanel.PanelLayout.from_plan(tp)
    dr, di = lay.densify_a(tp, a.data.real.copy(), a.data.imag.copy())
    mask4 = lay.mask[:, None, :, None].astype(np.float64)
    xv = rng.standard_normal((2, tp.nnzb_x, lm, ln))
    xp = [lay.pack_x(v) for v in xv]
    jm = jpanel.dense_multiply(jnp.asarray(dr), jnp.asarray(di),
                               jnp.asarray(mask4), lay.mb, lm, lay.ncc, ln,
                               None)
    want = [np.asarray(v) for v in jm(tuple(jnp.asarray(p) for p in xp))]
    tm = tpanel.dense_multiply(torch.from_numpy(dr), torch.from_numpy(di),
                               torch.from_numpy(mask4), lay.mb, lm, lay.ncc,
                               ln)
    got = [v.numpy() for v in tm(tuple(torch.from_numpy(p) for p in xp))]
    scale = max(np.max(np.abs(w)) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        assert np.max(np.abs(g - w)) <= 1e-12 * scale
    assert tpanel.flops_dense_multiply(lay.mb, lm, lay.ncc, ln) == \
        jpanel.flops_dense_multiply(lay.mb, lm, lay.ncc, ln)


@pytest.mark.parametrize("seed,mb,lm,ln,ncols,tol", [
    (0, 12, 4, 8, 3, 1e-10), (1, 10, 8, 8, 2, 1e-9),
])
def test_dense_solve_matches_jax(monkeypatch, seed, mb, lm, ln, ncols, tol):
    a, x, b = make_random_problem(np.random.default_rng(seed), mb=mb, lm=lm,
                                  ln=ln, ncols=ncols)
    res = jax_and_port(monkeypatch, a, x, b, engine="dense", precision="z",
                       tol=tol, maxit=200)
    assert res[3].return_status == Status.SUCCESS
    assert_same_solve(*res, rtol=1e-10)


def test_dense_trivial_rhs_and_initial_guess_match_jax(monkeypatch):
    a, x, b = make_random_problem(np.random.default_rng(5), mb=10, lm=4,
                                  ln=8, ncols=2, x_fill=1.0)
    res = jax_and_port(monkeypatch, a, x, b, engine="dense", precision="z",
                       tol=1e-10, maxit=200, rhs_trivial=True)
    assert res[3].return_status == Status.SUCCESS
    assert_same_solve(*res, rtol=1e-10)
    rng = np.random.default_rng(6)
    x0 = 0.01 * (rng.standard_normal((x.nnzb, 4, 8))
                 + 1j * rng.standard_normal((x.nnzb, 4, 8)))
    res = jax_and_port(monkeypatch, a, x, b, engine="dense", precision="z",
                       tol=1e-10, maxit=200, x0=x0)
    assert res[3].return_status == Status.SUCCESS
    assert_same_solve(*res, rtol=1e-10)


def test_dense_float32_refuses_tf32():
    a, x, b = make_random_problem(np.random.default_rng(7), mb=6, lm=4, ln=4,
                                  ncols=1, dtype=np.complex64)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(tt.TfqmrgpuError) as e:
            tt.Solver(*_port(a, x, b), precision="c", engine="dense",
                      device="cpu")
        assert e.value.code == Status.PRECISION_MISSMATCH
    finally:
        torch.set_float32_matmul_precision(before)
    # 'z' is native float64 whatever the float32 setting
    tt.Solver(*_port(a, x, b), precision="z", engine="dense", device="cpu")


def test_fd_auto_dense_reaches_dense_reference():
    """FD rtb=6.75 through bsrsv_z's 'auto', which picks 'dense' there."""
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    prob = generate_fd_problem(rtb=6.75, reference=True)
    xs, info = tt.bsrsv_z(prob.a_with_data(), prob.x, prob.b_with_data(),
                          tolerance=1e-9, max_iterations=2000, device="cpu")
    assert info.engine == "dense"
    assert info.return_status == Status.SUCCESS
    assert info.residuum_reached <= 1e-9
    ref = prob.x_reference.astype(np.float64)
    assert np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("engine", ["dense", "pallas"])
def test_complex64_panel_solve_and_layouts(engine):
    a, x, b = make_random_problem(np.random.default_rng(4), mb=10, lm=4,
                                  ln=8, ncols=2, dtype=np.complex64)
    s = tt.Solver(*_port(a, x, b), precision="c", engine=engine,
                  device="cpu")
    info = s.solve(tolerance=1e-5, max_iterations=200)
    assert info.engine == engine
    assert info.return_status == Status.SUCCESS
    xc = s.get_matrix("X")
    assert xc.dtype == np.complex64
    ones = x.with_data(np.ones((x.nnzb, 4, 8)))
    mask = dense_from_bsr(ones, 4, 8) != 0
    r = dense_from_bsr(a, 4, 4) @ dense_from_bsr(x.with_data(xc), 4, 8) \
        - dense_from_bsr(b, 4, 8)
    assert np.linalg.norm(r[mask]) / np.linalg.norm(
        dense_from_bsr(b, 4, 8)) < 1e-4
    riri = s.get_matrix("X", layout=0x55)
    assert np.array_equal(riri[..., 0], xc.real)
    assert np.array_equal(s.get_matrix("X", trans="h"),
                          np.conj(np.swapaxes(xc, 1, 2)))


def _golden_patterns():
    """chip_smoke.py's golden-class patterns as the JAX package's Bsr."""
    from chip_smoke import golden_class_patterns
    from tfqmrgpu_tpu.bsr import Bsr as JBsr

    return [JBsr(m.nrows, m.ncols, m.rowptr, m.colind, None, m.name)
            for m in golden_class_patterns()]


def _fd_patterns(rtb):
    from tfqmrgpu_tpu.generator import generate_fd_problem

    p = generate_fd_problem(rtb=rtb)
    return p.a, p.x, p.b


@pytest.mark.parametrize("case,precision,lm,want", [
    ("random", "z", 4, "dense"),
    ("fd6.75", "z", 8, "dense"),
    ("fd12.75", "c", 8, "pairs"),
    ("golden", "c", 32, "pallas"),
])
def test_auto_picks_jax_engine(monkeypatch, case, precision, lm, want):
    if case == "random":
        a, x, b = (dataclasses.replace(m, data=None) for m in
                   make_random_problem(np.random.default_rng(8), mb=12,
                                       lm=lm, ln=lm, ncols=3))
    elif case == "golden":
        a, x, b = _golden_patterns()
    else:
        a, x, b = _fd_patterns(float(case[2:]))
    js = jsolver.Solver(a, x, b, precision=precision, lm=lm, ln=lm)
    ts = tt.Solver(*_port(a, x, b), precision=precision, lm=lm, ln=lm,
                   device="cpu")
    assert js.engine == ts.engine == want
    if want == "pairs":
        # the packed 'c' engine, ungrouped (one column); at LM 8 'auto'
        # merges block rows where the card's rates say it pays (the JAX
        # package by its own table), as pack_superblock decides
        assert ts._pp_plan is not None and ts._gp is None
        try:
            rm = tsolver.pack_superblock(ts.plan, lm, lm)[0]
        except ValueError:
            rm = None
        assert (ts._sup is None) == (rm is None)
        cells = ts.plan.nnzb_x if rm is None else rm.n_cells
        assert ts._pp_plan.n_slots == cells
        # with the merge off: the fine cells
        monkeypatch.setenv("TFQ_SOLVER_SUPER", "0")
        fine = tt.Solver(*_port(a, x, b), precision=precision, lm=lm, ln=lm,
                         device="cpu")
        assert fine._sup is None and fine._gp is None
        assert fine._pp_plan.n_slots == fine.plan.nnzb_x
    if want == "pallas":
        assert (ts._pack.r_tile, ts._pack.ku) == (js._pack.r_tile,
                                                  js._pack.ku) == (2, 12)


@pytest.mark.parametrize("call", ["Solver", "bsrsv_z", "create_plan",
                                  "plan_from_numpy"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """Without a device argument the entry points run on CUDA; with no
    card they raise and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, x, b = make_random_problem(np.random.default_rng(9), mb=6, lm=4, ln=4,
                                  ncols=1)
    pa, px, pb = _port(a, x, b)
    fns = {
        "Solver": lambda: tt.Solver(pa, px, pb),
        "bsrsv_z": lambda: tt.bsrsv_z(pa, px, pb),
        "create_plan": lambda: tt.create_plan(pa, px, pb),
        "plan_from_numpy": lambda: convert.plan_from_numpy(**{
            k: getattr(jcreate_plan(a, x, b, cache=False), k)
            for k in convert.PLAN_FIELDS}),
    }
    with pytest.raises(tt.TfqmrgpuError, match='device="cpu"'):
        fns[call]()

"""The port's superblock row merge (``tfqmrgpu_tpu_torch/ops/superblock.py``)
and its composition into the packed 'c' 'pairs' engine, against the JAX
package on the CPU.

* Tables: ``pack_rowmerge`` (given and recovered labels, f = 2 and 4, and
  composed after ``pack_grouped``), ``group_rows_greedy`` and the
  refusals are the JAX package's to the bit; so are ``merge_a_blocks``,
  ``merge_xy_blocks``, ``unmerge_xy_blocks``, ``merged_x_mask`` and
  ``merged_mask_full`` on numpy data, and the torch-tensor inputs give the
  numpy results; ``auto_f_row`` with an explicit rate table picks JAX's
  factor.
* The merged multiply: K2's plain version over the merged plan, unmerged,
  within 1e-5 relative of the fine numpy pair walk.
* Solves: ``Solver(precision='c', engine='pairs')`` with
  TFQ_SOLVER_SUPER=f against 'dense' (the JAX package's
  tests/test_solver_superblock.py cases), two whole solves against JAX's
  superblock solve with the JAX plan and v3 handed over (status,
  iterations +-2, X within 1e-4), the TFQ_SUPER_MIN_MACS floor and the
  rates under 'auto', ``solve_checkpointed``, 'm', an initial guess, the
  trivial right-hand side, and 'z', which TFQ_SOLVER_SUPER leaves alone.
"""

import numpy as np
import pytest
import torch

from conftest import dense_from_bsr, make_random_problem
from test_superblock import random_full_intersection, ref_multiply
from test_torch_panel import _port
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.ops import pairpanel as jpp
from tfqmrgpu_tpu.ops import superblock as jsb
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch import solver as tsolver
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp
from tfqmrgpu_tpu_torch.ops import rates as trates
from tfqmrgpu_tpu_torch.ops import superblock as tsb

torch.set_num_threads(2)

RM_FIELDS = ("f_row", "lm", "ln", "lm2", "n_in", "n_cells", "n_acells",
             "pair_a2", "pair_x2", "pair_y2", "cell_of", "rpos_of", "src_of",
             "a_src", "a_cell", "a_rpos", "a_cpos", "row_of2", "col_of2",
             "mac_inflation")


def _same(got, want, fields=RM_FIELDS):
    for k in fields:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert g == w, k


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("TFQ_SOLVER_SUPER", "TFQ_SUPER_MIN_MACS", "TFQ_PAIRS_RTILE",
              "TFQ_PAIRS_COLGROUP"):
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("known", [False, True])
@pytest.mark.parametrize("f_row", [2, 4])
def test_pack_rowmerge_identical(f_row, known):
    pa, px, py, nnzb, _, xr, xc = random_full_intersection(
        18, 4, seed=20 + f_row)
    kw = dict(row_of=xr, col_of=xc) if known else {}
    want = jsb.pack_rowmerge(pa, px, py, nnzb, 8, 8, f_row, **kw)
    got = tsb.pack_rowmerge(pa, px, py, nnzb, 8, 8, f_row, **kw)
    _same(got, want)


@pytest.mark.parametrize("f_row", [2, 4])
def test_pack_rowmerge_after_grouping_identical(f_row):
    pa, px, py, nnzb, _, xr, xc = random_full_intersection(20, 6, p_x=0.6,
                                                           seed=30)
    jgp = jpp.pack_grouped(pa, px, py, nnzb, 8, 4, row_of=xr, col_of=xc)
    tgp = tpp.pack_grouped(pa, px, py, nnzb, 8, 4, row_of=xr, col_of=xc)
    args = lambda gp: (gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, 8,
                       gp.ln2, f_row)
    want = jsb.pack_rowmerge(*args(jgp), row_of=jgp.row_of2,
                             col_of=jgp.col_of2, verify=False)
    got = tsb.pack_rowmerge(*args(tgp), row_of=tgp.row_of2,
                            col_of=tgp.col_of2, verify=False)
    _same(got, want)


@pytest.mark.parametrize("window", [64, 3])
def test_group_rows_greedy_identical(window):
    rng = np.random.default_rng(40 + window)
    nrow = 30
    adj = [sorted({i, *rng.integers(0, nrow, 4).tolist()})
           for i in range(nrow)]
    rowptr = np.concatenate([[0], np.cumsum([len(r) for r in adj])])
    colind = np.array([c for r in adj for c in r], np.int64)
    order = rng.permutation(nrow)
    for f_row in (2, 3, 4):
        assert (tsb.group_rows_greedy(rowptr, colind, order, f_row, window)
                == jsb.group_rows_greedy(rowptr, colind, order, f_row,
                                         window))


def _partial():
    pa, px, py, nnzb, _, xr, xc = random_full_intersection(12, 4)
    counts = np.bincount(pa)
    keep = np.ones(len(pa), bool)
    keep[int(np.flatnonzero(counts[pa] >= 2)[0])] = False
    return ((pa[keep], px[keep], py[keep], nnzb, 8, 8, 2),
            dict(row_of=xr, col_of=xc))


def _duplicate_triple():
    pa, px, py, nnzb, _, _, _ = random_full_intersection(8, 3)
    return ((np.concatenate([pa, pa[:1]]), np.concatenate([px, px[:1]]),
             np.concatenate([py, py[:1]]), nnzb, 8, 8, 2), {})


def _duplicate_endpoints():
    return ((np.array([0, 1, 3, 2]), np.array([0, 1, 1, 1]),
             np.array([0, 0, 0, 1]), 2, 4, 8, 2),
            dict(row_of=np.array([0, 1]), col_of=np.array([0, 0])))


def _small_factor():
    pa, px, py, nnzb, _, _, _ = random_full_intersection(8, 3)
    return (pa, px, py, nnzb, 8, 8, 1), {}


def _single_row():
    # one block row of two columns, A = its diagonal block
    return ((np.array([0, 0]), np.array([0, 1]), np.array([0, 1]), 2, 8, 8,
             2), dict(row_of=np.array([0, 0]), col_of=np.array([0, 1])))


@pytest.mark.parametrize("case,match", [
    (_partial, "full pattern intersection"),
    (_duplicate_triple, "duplicate"),
    (_duplicate_endpoints, "duplicate A blocks"),
    (_small_factor, "f_row >= 2"),
    (_single_row, ">= 2 rows")])
def test_rowmerge_refusals_are_jax_refusals(case, match):
    args, kw = case()
    with pytest.raises(ValueError, match=match) as want:
        jsb.pack_rowmerge(*args, **kw)
    with pytest.raises(ValueError, match=match) as got:
        tsb.pack_rowmerge(*args, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("grouped", [False, True])
def test_merges_and_masks_identical(grouped):
    rng = np.random.default_rng(50 + grouped)
    pa, px, py, nnzb, nnzba, xr, xc = random_full_intersection(
        16, 4, p_x=0.6, seed=51)
    lm, ln, f = 8, 8, 4
    gp = tgp = None
    if grouped:
        gp = jpp.pack_grouped(pa, px, py, nnzb, ln, 2, row_of=xr, col_of=xc)
        tgp = tpp.pack_grouped(pa, px, py, nnzb, ln, 2, row_of=xr, col_of=xc)
        pa_, px_, py_, n_, ln_ = (gp.pair_a2, gp.pair_x2, gp.pair_y2,
                                  gp.nnzb2, gp.ln2)
        kw = dict(row_of=gp.row_of2, col_of=gp.col_of2, verify=False)
    else:
        pa_, px_, py_, n_, ln_ = pa, px, py, nnzb, ln
        kw = dict(row_of=xr, col_of=xc)
    jrm = jsb.pack_rowmerge(pa_, px_, py_, n_, lm, ln_, f, **kw)
    trm = tsb.pack_rowmerge(pa_, px_, py_, n_, lm, ln_, f, **kw)
    a = rng.standard_normal((nnzba, lm, lm)).astype(np.float32)
    x = rng.standard_normal((n_, lm, ln_)).astype(np.float32)
    cells = rng.standard_normal((trm.n_cells, trm.lm2, ln_)).astype(
        np.float32)
    pairs = ((jsb.merge_a_blocks(jrm, a), tsb.merge_a_blocks(trm, a)),
             (jsb.merge_xy_blocks(jrm, x), tsb.merge_xy_blocks(trm, x)),
             (jsb.unmerge_xy_blocks(jrm, cells),
              tsb.unmerge_xy_blocks(trm, cells)),
             (jsb.merged_x_mask(jrm), tsb.merged_x_mask(trm)),
             (jsb.merged_mask_full(jrm, gp), tsb.merged_mask_full(trm, tgp)))
    for want, got in pairs:
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # torch tensors in, the numpy results out (as tensors)
    for fn, v in ((tsb.merge_a_blocks, a), (tsb.merge_xy_blocks, x),
                  (tsb.unmerge_xy_blocks, cells)):
        t = fn(trm, torch.from_numpy(v))
        assert torch.is_tensor(t)
        assert np.array_equal(t.numpy(), fn(trm, v))
    # the dead merged slots are zero, and the live ones under the mask
    x2 = tsb.merge_xy_blocks(trm, x)
    assert np.array_equal(x2 * tsb.merged_x_mask(trm), x2)


@pytest.mark.parametrize("speed", [{16: 2.0, 32: 8.1}, {16: 9.0, 32: 1.0}])
def test_auto_f_row_picks_the_jax_factor(speed):
    pa, px, py, nnzb, _, xr, xc = random_full_intersection(24, 4, seed=60)
    want, jpacks = jsb.auto_f_row(pa, px, py, nnzb, 8, 32, speed_tf=speed,
                                  row_of=xr, col_of=xc)
    got, tpacks = tsb.auto_f_row(pa, px, py, nnzb, 8, 32, speed_tf=speed,
                                 row_of=xr, col_of=xc)
    # the unmerged baseline is each package's table: compare the choice
    # among the factors where both say merging pays
    assert sorted(tpacks) == sorted(jpacks)
    for f in tpacks:
        _same(tpacks[f], jpacks[f])
    costs = {f: tpacks[f].mac_inflation / speed[f * 8] for f in tpacks}
    best = min(costs, key=costs.get)
    assert want in (1, best) and got in (1, best)
    base = 1.0 / trates.base_rate("c", 8)
    assert got == (best if costs[best] < base else 1)


def test_auto_f_row_never_merges_z():
    pa, px, py, nnzb, _, xr, xc = random_full_intersection(24, 4, seed=61)
    assert tsb.auto_f_row(pa, px, py, nnzb, 8, 8, row_of=xr, col_of=xc,
                          precision="z") == (1, {})


# ------------------------------------------------------- merged multiply

@pytest.mark.parametrize("f_row,group", [(2, 1), (4, 2)])
def test_merged_multiply_matches_fine_pair_walk(f_row, group):
    rng = np.random.default_rng(70 + f_row)
    lm, ln = 8, 8
    pa, px, py, nnzb, nnzba, xr, xc = random_full_intersection(
        20, 4, p_x=0.7, seed=71)
    a = (rng.standard_normal((nnzba, lm, lm))
         + 1j * rng.standard_normal((nnzba, lm, lm)))
    x = (rng.standard_normal((nnzb, lm, ln))
         + 1j * rng.standard_normal((nnzb, lm, ln)))
    want = ref_multiply(pa, px, py, a, x, nnzb)
    gp = None
    if group > 1:
        gp = tpp.pack_grouped(pa, px, py, nnzb, ln, group, row_of=xr,
                              col_of=xc)
        rm = tsb.pack_rowmerge(gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2,
                               lm, gp.ln2, f_row, row_of=gp.row_of2,
                               col_of=gp.col_of2, verify=False)
    else:
        rm = tsb.pack_rowmerge(pa, px, py, nnzb, lm, ln, f_row, row_of=xr,
                               col_of=xc)
    plan = tpp.pack_pair_plan(rm.pair_a2, rm.pair_x2, rm.pair_y2, rm.n_cells,
                              rm.n_cells, rm.lm2, rm.ln, r_tile=1,
                              row_of=rm.row_of2, col_of=rm.col_of2)
    planes = [np.ascontiguousarray(v, np.float32) for v in (x.real, x.imag)]
    if gp is not None:
        planes = [tpp.grouped_blocks(gp, v) for v in planes]
    planes = [tsb.merge_xy_blocks(rm, v) for v in planes]
    a_re, a_im = (tsb.merge_a_blocks(rm, torch.from_numpy(
        np.ascontiguousarray(v, np.float32))) for v in (a.real, a.imag))
    mult = tpp.PairPanelMultiply(plan, tpp.build_a_panels_device(plan, a_re,
                                                                 a_im))
    assert mult.lm == f_row * lm
    y = mult(torch.from_numpy(tpp.permute_x(plan, *planes)))
    re, im = (tsb.unmerge_xy_blocks(rm, v)
              for v in tpp.unpermute_y(plan, y.numpy()))
    if gp is not None:
        re, im = tpp.ungroup_blocks(gp, re), tpp.ungroup_blocks(gp, im)
    got = re + 1j * im
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


# ------------------------------------------------------------------ solves

def _residual(a, x, b, got, lm, ln):
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(got), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    return np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd))


@pytest.mark.parametrize("lm,ln,f", [(8, 8, 4), (4, 8, 4)])
def test_super_solver_c_matches_dense(monkeypatch, lm, ln, f):
    a, x, b = make_random_problem(np.random.default_rng(80 + lm), mb=24,
                                  lm=lm, ln=ln, ncols=4, x_fill=1.0,
                                  dtype=np.complex64)
    monkeypatch.setenv("TFQ_SOLVER_SUPER", str(f))
    s = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                  device="cpu")
    assert s._sup is not None and s._sup.f_row == f
    assert s._pp_plan.lm == f * lm and s._multiply.lm == f * lm
    info = s.solve(tolerance=1e-4, max_iterations=400)
    assert info.return_status == Status.SUCCESS
    assert _residual(a, x, b, s.get_matrix("X"), lm, ln) < 2e-4
    d = tt.Solver(*_port(a, x, b), precision="c", engine="dense",
                  device="cpu")
    dinfo = d.solve(tolerance=1e-4, max_iterations=400)
    assert abs(info.iterations_needed - dinfo.iterations_needed) <= 3
    # the fine plan's accounting (JAX: its solver.py:1030-1033)
    p = s.plan
    assert info.flops_performed == (
        info.iterations_needed * tt.core.flops_per_iteration(
            p.n_pairs, p.nnzb_x, lm, ln)
        + info.n_probes * tt.core.flops_per_probe(p.n_pairs, p.nnzb_x, lm,
                                                  ln))


@pytest.mark.parametrize("lm,f", [(8, 4), (4, 2)])
def test_super_solve_matches_jax(monkeypatch, lm, f):
    """The same merged 'c' solve through both packages (JAX's packed
    kernel in interpret mode), the JAX plan and v3 handed over."""
    ln = 8
    monkeypatch.setenv("TFQ_SOLVER_SUPER", str(f))
    a, x, b = make_random_problem(np.random.default_rng(90 + lm), mb=16,
                                  lm=lm, ln=ln, ncols=4, x_fill=1.0,
                                  dtype=np.complex64)
    js = jsolver.Solver(a, x, b, precision="c", engine="pairs")
    assert js._sup is not None and js._sup.f_row == f
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, lm, ln)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="c", engine="pairs", plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    _same(ts._sup, js._sup)
    jinfo = js.solve(tolerance=1e-5, max_iterations=300)
    tinfo = ts.solve(tolerance=1e-5, max_iterations=300)
    assert tinfo.return_status == jinfo.return_status == Status.SUCCESS
    assert abs(tinfo.iterations_needed - jinfo.iterations_needed) <= 2
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def _small_c(seed=100, mb=10, lm=8, ln=8, ncols=4):
    return make_random_problem(np.random.default_rng(seed), mb=mb, lm=lm,
                               ln=ln, ncols=ncols, x_fill=1.0,
                               dtype=np.complex64)


@pytest.mark.parametrize("min_macs,pays,merged", [
    (None, True, False),     # below the default floor: never under 'auto'
    ("0", True, True),       # no floor, and the rates say it pays
    ("0", False, False)])    # no floor, and the rates say it does not
def test_auto_size_floor_and_rates(monkeypatch, min_macs, pays, merged):
    if min_macs is not None:
        monkeypatch.setenv("TFQ_SUPER_MIN_MACS", min_macs)
    monkeypatch.setitem(trates.ENGINE_TFLOPS, "c",
                        {16: 1e6, 32: 1e6} if pays else {16: 1e-6,
                                                          32: 1e-6})
    a, x, b = _small_c()
    s = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                  device="cpu")
    assert (s._sup is not None) == merged
    # a forced factor bypasses the floor and the rates
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "4")
    s = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                  device="cpu")
    assert s._sup is not None and s._sup.f_row == 4


def test_super_checkpointed_restart(monkeypatch, tmp_path):
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "4")
    a, x, b = _small_c(seed=101, mb=16)
    port = _port(a, x, b)
    state = str(tmp_path / "state")
    s1 = tt.Solver(*port, precision="c", engine="pairs", device="cpu")
    assert s1._sup is not None
    info = s1.solve_checkpointed(tolerance=1e-5, max_iterations=2, chunk=2,
                                 state_path=state)
    assert info.return_status != Status.SUCCESS
    with np.load(state + ".npz") as st:      # the state is in fine space
        assert st["x_re"].shape == (x.nnzb, 8, 8)
    s2 = tt.Solver(*port, precision="c", engine="pairs", device="cpu")
    info2 = s2.solve_checkpointed(tolerance=1e-5, max_iterations=400,
                                  chunk=50, state_path=state)
    assert info2.return_status == Status.SUCCESS
    assert _residual(a, x, b, s2.get_matrix("X"), 8, 8) < 2e-4


def test_super_mixed_c_stage(monkeypatch):
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "4")
    a, x, b = make_random_problem(np.random.default_rng(102), mb=12, lm=8,
                                  ln=8, ncols=3, x_fill=1.0)
    xs, info = tt.solve_mixed(*_port(a, x, b), tolerance=1e-10,
                              max_iterations=500, engine="pairs",
                              device="cpu")
    assert info.return_status == Status.SUCCESS
    assert info.refinement["c_engine"] == "pairs"
    assert not info.refinement["fallback"]
    assert _residual(a, x, b, xs.data, 8, 8) < 1e-8


@pytest.mark.parametrize("case", ["initial_guess", "trivial_rhs"])
def test_super_initial_guess_and_trivial_rhs(monkeypatch, case):
    a, x, b = _small_c(seed=103, mb=12)
    port = _port(a, x, b)
    rng = np.random.default_rng(104)
    guess = (0.01 * (rng.standard_normal((x.nnzb, 8, 8))
                     + 1j * rng.standard_normal((x.nnzb, 8, 8)))
             ).astype(np.complex64)
    got = {}
    for f in ("0", "4"):
        monkeypatch.setenv("TFQ_SOLVER_SUPER", f)
        s = tt.Solver(*port, precision="c", engine="pairs", device="cpu")
        assert (s._sup is not None) == (f == "4")
        if case == "initial_guess":
            s.set_matrix("X", guess)
        info = s.solve(tolerance=1e-6, max_iterations=300,
                       rhs_trivial=case == "trivial_rhs")
        assert info.return_status == Status.SUCCESS
        got[f] = s.get_matrix("X")
    if case == "initial_guess":
        assert _residual(a, x, b, got["4"], 8, 8) < 1e-5
    scale = np.max(np.abs(got["0"]))
    assert np.max(np.abs(got["4"] - got["0"])) <= 1e-5 * scale


def test_z_is_unaffected_by_super(monkeypatch):
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    a, x, b = make_random_problem(np.random.default_rng(105), mb=12, lm=8,
                                  ln=8, ncols=3, x_fill=1.0)
    out = []
    for f in (None, "4"):
        if f is not None:
            monkeypatch.setenv("TFQ_SOLVER_SUPER", f)
        s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                      device="cpu")
        assert s._sup is None and s._pp_plan is None
        assert isinstance(s._multiply, PairPlanMultiply)
        info = s.solve(tolerance=1e-10, max_iterations=300)
        out.append((info.iterations_needed, s.get_matrix("X")))
    assert out[0][0] == out[1][0] and np.array_equal(out[0][1], out[1][1])

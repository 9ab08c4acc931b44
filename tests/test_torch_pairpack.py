"""The port's packed 'pairs' engine for 'c' against the JAX package's on the
CPU.

* Tables: the resident pair plan, the column grouping, the lane mask, the
  permutations and the A panels are bit-identical to the JAX package's.
* K2's plain version against the TPU kernel ``kernel_tile_pipe`` run in
  interpret mode at precision 'highest', both within 1e-5 relative of the
  numpy pair walk and of each other (FP32 sums in another order).
* The fused primitives against JAX's ``fused_primitives``: axpy, xpay and
  add_rhs within 1e-6 of the largest entry; dotp and nrm2 within 1e-6 of
  a float64 sum, and within 1e-5 of JAX's, whose column sums go through a
  one-hot product of bf16 hi/lo halves (2^-17 relative per term, measured
  ~3e-6 here).
* Whole 'c' solves, the JAX plan and v3 handed over: the same status,
  iterations within +-2, X within 1e-4 relative and the same flops, the
  tolerances of the JAX package's own tile-pipe solve test
  (tests/test_pairs_engine.py::test_pairs_engine_tile_pipe_solve).  The
  JAX side runs its fine resident plan through the tile pipeline
  (TFQ_SOLVER_SUPER=0, TFQ_PAIRS_RESIDENT=1, TFQ_PAIRS_TILEPIPE=1) at a
  forced group size, and the port's chooser is forced to the same one.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_problem
from test_pairpanel import _bsr_pair_plan, _np_pairwalk
from test_torch_panel import _port
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.ops import pairpanel as jpp
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch import solver as tsolver
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp
from tfqmrgpu_tpu_torch.ops import paneltiles

torch.set_num_threads(2)

PLAN_FIELDS = ("ntiles", "r_tile", "ku", "lm", "ln", "nnzb_x", "nnzb_y",
               "n_slots", "perm", "inv_perm", "xloc", "kcount", "pair_tile",
               "pair_rslot", "pair_kslot", "pair_a", "inflation",
               "col_of_new")
GROUP_FIELDS = ("group_size", "ncol", "ngroups", "nnzb2", "ln2", "pair_a2",
                "pair_x2", "pair_y2", "row_of2", "col_of2", "src_of",
                "cell_of_blk", "lane_of_blk", "groups")


def _same(got, want, fields):
    for k in fields:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert g == w, k


def _geometry(mb, ncols):
    """The (row, column) of every X block of ``_bsr_pair_plan``."""
    return np.repeat(np.arange(mb), ncols), np.tile(np.arange(ncols), mb)


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("r_tile", [1, 2, 4])
@pytest.mark.parametrize("known", [False, True])
def test_pack_pair_plan_identical(r_tile, known):
    rng = np.random.default_rng(10 + r_tile)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=13, ncols=3,
                                        stencil=(0, 1, 3))
    kw = {}
    if known:
        kw = dict(zip(("row_of", "col_of"), _geometry(13, 3)))
    want = jpp.pack_pair_plan(pa, px, py, nx, nx, 4, 4, r_tile=r_tile,
                              resident=True, **kw)
    got = tpp.pack_pair_plan(pa, px, py, nx, nx, 4, 4, r_tile=r_tile, **kw)
    _same(got, want, PLAN_FIELDS)


@pytest.mark.parametrize("group_size", [2, 4])
def test_pack_grouped_identical(group_size):
    rng = np.random.default_rng(20 + group_size)
    a, x, b = make_random_problem(rng, mb=12, lm=4, ln=4, ncols=8,
                                  x_fill=0.5)
    jp = jsolver.Solver(a, x, b, precision="c", engine="xla").plan
    pair_y = np.repeat(np.arange(jp.nnzb_x), np.diff(jp.starts))
    row_of = np.repeat(np.arange(jp.nrows), np.diff(jp.rowptr_x))
    args = (jp.pairs[:, 0], jp.pairs[:, 1], pair_y, jp.nnzb_x, 4, group_size)
    kw = dict(row_of=row_of, col_of=jp.colindx)
    gp = tpp.pack_grouped(*args, **kw)
    _same(gp, jpp.pack_grouped(*args, **kw), GROUP_FIELDS)
    # the grouped pack, the lane mask and the block (un)grouping
    pargs = (gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2, 4,
             gp.ln2)
    pkw = dict(r_tile=1, row_of=gp.row_of2, col_of=gp.col_of2)
    jplan = jpp.pack_pair_plan(*pargs, resident=True, **pkw)
    tplan = tpp.pack_pair_plan(*pargs, **pkw)
    _same(tplan, jplan, PLAN_FIELDS)
    mask = tpp.grouped_lane_mask(tplan, gp)
    want = jpp.grouped_lane_mask(jplan, gp)
    assert mask.dtype == want.dtype and np.array_equal(mask, want)
    blocks = rng.standard_normal((jp.nnzb_x, 4, 4)).astype(np.float32)
    cells = tpp.grouped_blocks(gp, blocks)
    assert np.array_equal(cells, np.asarray(jpp.grouped_blocks(gp, blocks)))
    assert np.array_equal(tpp.ungroup_blocks(gp, cells), blocks)


def test_pack_grouped_refuses_what_jax_refuses():
    rng = np.random.default_rng(30)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=10, ncols=4)
    keep = np.arange(pa.shape[0]) != 3        # not a full intersection
    dup = np.r_[np.arange(pa.shape[0]), 0]    # a duplicate triple
    for sel, what in ((keep, "full pattern intersection"),
                      (dup, "duplicate")):
        for mod in (jpp, tpp):
            with pytest.raises(ValueError, match=what):
                mod.pack_grouped(pa[sel], px[sel], py[sel], nx, 4, 2)


@pytest.mark.parametrize("r_tile", [1, 2])
def test_permutations_and_panels_identical(r_tile):
    rng = np.random.default_rng(40 + r_tile)
    lm, ln = 4, 5
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=11, ncols=2)
    sel = np.r_[np.arange(pa.shape[0]), 0, 5]      # duplicate pairs add up
    pa, px, py = pa[sel], px[sel], py[sel]
    jplan = jpp.pack_pair_plan(pa, px, py, nx, nx, lm, ln, r_tile=r_tile,
                               resident=True)
    tplan = tpp.pack_pair_plan(pa, px, py, nx, nx, lm, ln, r_tile=r_tile)
    _same(tplan, jplan, PLAN_FIELDS)
    re, im = rng.standard_normal((2, nx, lm, ln)).astype(np.float32)
    fused = tpp.permute_x(tplan, re, im)
    assert np.array_equal(fused, jpp.permute_x(jplan, re, im))
    for got, want in zip(tpp.unpermute_y(tplan, fused),
                         jpp.unpermute_y(jplan, fused)):
        assert np.array_equal(got, want)
    a_re, a_im = rng.standard_normal((2, na, lm, lm)).astype(np.float32)
    want = jpp.build_a_panels(jplan, a_re, a_im)
    assert np.array_equal(tpp.build_a_panels(tplan, a_re, a_im), want)
    dev = tpp.build_a_panels_device(tplan, torch.from_numpy(a_re),
                                    torch.from_numpy(a_im))
    assert np.array_equal(dev.numpy(), want)


def test_golden_class_pack_picks_g8_like_jax():
    """Pattern only: the port's chooser picks G=8 at the golden class (its
    rates tie every G there, and the larger G wins), as the JAX package
    does, and the packed tables are the JAX package's."""
    from chip_smoke import golden_class_patterns

    a, x, b = golden_class_patterns()
    t0 = time.perf_counter()
    ts = tt.Solver(a, x, b, precision="c", engine="pairs", lm=32, ln=32,
                   device="cpu")
    assert time.perf_counter() - t0 < 30.0
    assert ts._gp is not None and ts._gp.group_size == 8
    plan = ts._pp_plan
    assert (plan.ntiles, plan.ku, plan.ln) == (562, 12, 256)
    p = ts.plan
    pair_y = np.repeat(np.arange(p.nnzb_x), np.diff(p.starts.numpy()))
    row_of = np.repeat(np.arange(p.nrows), np.diff(p.rowptr_x))
    pairs, cols = p.pairs.numpy(), p.colindx.numpy()
    gp = jpp.pack_grouped(pairs[:, 0], pairs[:, 1], pair_y, p.nnzb_x, 32, 8,
                          row_of=row_of, col_of=cols)
    _same(ts._gp, gp, GROUP_FIELDS)
    jplan = jpp.pack_pair_plan(gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2,
                               gp.nnzb2, 32, gp.ln2, r_tile=1,
                               row_of=gp.row_of2, col_of=gp.col_of2,
                               resident=True)
    _same(plan, jplan, PLAN_FIELDS)
    _, ests = tpp.auto_group_size(pairs[:, 0], pairs[:, 1], pair_y,
                                  p.nnzb_x, 32, 32, row_of=row_of,
                                  col_of=cols)
    least = min(e["est_ms"] for e in ests.values())
    assert all(e["est_ms"] <= least * (1 + tpp.GROUP_TIE)
               for e in ests.values())


# ---------------------------------------------------------------- K2 plain

@pytest.mark.parametrize("lm,ln,r_tile,group", [
    (4, 4, 1, 1), (4, 4, 2, 1), (4, 4, 1, 2), (4, 128, 1, 1),
])
def test_k2_plain_matches_tile_pipe_interpret(monkeypatch, lm, ln, r_tile,
                                              group):
    monkeypatch.setenv("TFQ_PAIRS_TILEPIPE", "1")
    rng = np.random.default_rng(50 + ln + r_tile + group)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=10, ncols=2, lm=lm, ln=ln)
    a = rng.standard_normal((na, lm, lm)) + 1j * rng.standard_normal(
        (na, lm, lm))
    x = rng.standard_normal((nx, lm, ln)) + 1j * rng.standard_normal(
        (nx, lm, ln))
    want = _np_pairwalk(pa, px, py, a, x, nx)
    f32 = np.float32
    xre, xim = x.real.astype(f32), x.imag.astype(f32)
    if group > 1:
        gp = tpp.pack_grouped(pa, px, py, nx, ln, group)
        args = (gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2, lm,
                gp.ln2)
        kw = dict(row_of=gp.row_of2, col_of=gp.col_of2)
        xre, xim = tpp.grouped_blocks(gp, xre), tpp.grouped_blocks(gp, xim)
    else:
        args, kw = (pa, px, py, nx, nx, lm, ln), {}
    jplan = jpp.pack_pair_plan(*args, r_tile=r_tile, resident=True, **kw)
    tplan = tpp.pack_pair_plan(*args, r_tile=r_tile, **kw)
    assert jpp.use_tile_pipe(jplan, "highest")
    panels = tpp.build_a_panels(tplan, a.real.astype(f32), a.imag.astype(f32))
    fused = tpp.permute_x(tplan, xre, xim)
    jm = jpp.make_pairpanel_multiply(jplan, jnp.asarray(panels),
                                     precision="highest", interpret=True)
    jy = np.asarray(jm(jnp.asarray(fused)))[: tplan.n_slots * lm]
    tm = tpp.PairPanelMultiply(tplan, torch.from_numpy(panels))
    before = tpp.PairPanelMultiply.launches
    ty = tm(torch.from_numpy(fused)).numpy()
    assert tpp.PairPanelMultiply.launches == before     # the CPU never launches
    assert ty.dtype == np.float32 and ty.shape == jy.shape
    scale = np.max(np.abs(jy))
    assert np.max(np.abs(ty - jy)) <= 1e-5 * scale
    for y in (ty, jy):
        if group > 1:      # products on absent lanes are masked off
            m = tpp.grouped_lane_mask(tplan, gp)[:, None, :]
            y = (y.reshape(-1, lm, y.shape[1]) * m).reshape(y.shape)
        re, im = tpp.unpermute_y(tplan, y)
        if group > 1:
            re, im = tpp.ungroup_blocks(gp, re), tpp.ungroup_blocks(gp, im)
        got = re + 1j * im
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("lm,ln,r_tile,group", [
    (4, 4, 1, 2), (4, 4, 2, 2), (8, 8, 1, 4), (4, 16, 1, 4),
])
def test_k2_unit_tables_walk_grouped_plans(lm, ln, r_tile, group):
    """The tables K2 runs on the card, for plans packed in column groups:
    every tile's ``xloc`` slots in order, for the CTA shape of the fused
    lanes, and the plain walker over them bit for bit the plain version
    (integer data: every float32 sum is exact)."""
    rng = np.random.default_rng(90 + ln + r_tile + group)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=10, ncols=4, lm=lm, ln=ln)
    f32 = np.float32
    a = rng.integers(-3, 4, (2, na, lm, lm)).astype(f32)
    x = rng.integers(-3, 4, (2, nx, lm, ln)).astype(f32)
    gp = tpp.pack_grouped(pa, px, py, nx, ln, group)
    plan = tpp.pack_pair_plan(gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2,
                              gp.nnzb2, lm, gp.ln2, r_tile=r_tile,
                              row_of=gp.row_of2, col_of=gp.col_of2)
    panels = tpp.build_a_panels(plan, a[0], a[1])
    fused = torch.from_numpy(tpp.permute_x(
        plan, tpp.grouped_blocks(gp, x[0]), tpp.grouped_blocks(gp, x[1])))
    tm = tpp.PairPanelMultiply(plan, torch.from_numpy(panels))
    u, c = tm.units, plan.ln
    shape = paneltiles.cta_shape(c)
    assert c == group * ln
    assert (u.bm, u.union) == (shape[0], shape == paneltiles.WIDE)
    for t in range(plan.ntiles):
        g, n = divmod(t, u.nt)
        steps = np.flatnonzero(u.ukidx[g, :, n] >= 0)
        assert np.array_equal(u.ukidx[g, steps, n], np.arange(plan.kcount[t]))
        assert np.array_equal(u.uslot[g, steps, n],
                              plan.xloc[t, :plan.kcount[t]])
    items, _ = paneltiles.work_list(u, c, shape[1], 7)
    y_re, y_im, writes = paneltiles.walk(
        u, items, paneltiles.depth_major(tm.a_panels),
        fused[:, :c].contiguous(), fused[:, c:].contiguous(), lm,
        plan.n_slots * lm, shape[1])
    assert np.all(writes == 1)
    assert torch.equal(torch.cat([y_re, y_im], dim=1), tm.plain(fused))


def test_k2_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(60)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=8, ncols=2, lm=4, ln=4)
    plan = tpp.pack_pair_plan(pa, px, py, nx, nx, 4, 4, r_tile=1)
    panels = torch.zeros((plan.ntiles, 8, plan.ku * 4))
    tm = tpp.PairPanelMultiply(plan, panels)
    x = torch.zeros((plan.n_slots * 4, 8))
    with pytest.raises(ValueError):                   # float64 x
        tm(x.double())
    with pytest.raises(ValueError):                   # wrong shape
        tm(x[:-1])
    with pytest.raises(ValueError):                   # not contiguous
        tm(torch.zeros((8, plan.n_slots * 4)).t())
    with pytest.raises(ValueError):                   # panels of the wrong shape
        tpp.PairPanelMultiply(plan, panels[:-1])
    with pytest.raises(tt.TfqmrgpuError) as e:        # float32 only
        tpp.PairPanelMultiply(plan, panels.double())
    assert e.value.code == Status.PRECISION_MISSMATCH


# -------------------------------------------------------- fused primitives

@pytest.mark.parametrize("group", [1, 4])
def test_fused_primitives_match_jax(group):
    rng = np.random.default_rng(70 + group)
    a, x, b = make_random_problem(rng, mb=12, lm=4, ln=4, ncols=8,
                                  x_fill=0.6)
    jp = jsolver.Solver(a, x, b, precision="c", engine="xla").plan
    pair_y = np.repeat(np.arange(jp.nnzb_x), np.diff(jp.starts))
    row_of = np.repeat(np.arange(jp.nrows), np.diff(jp.rowptr_x))
    gp = None
    args = (jp.pairs[:, 0], jp.pairs[:, 1], pair_y, jp.nnzb_x, jp.nnzb_x, 4,
            4)
    kw = dict(row_of=row_of, col_of=jp.colindx)
    if group > 1:
        gp = tpp.pack_grouped(jp.pairs[:, 0], jp.pairs[:, 1], pair_y,
                              jp.nnzb_x, 4, group, **kw)
        args = (gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2, 4,
                gp.ln2)
        kw = dict(row_of=gp.row_of2, col_of=gp.col_of2)
    jplan = jpp.pack_pair_plan(*args, r_tile=1, resident=True, **kw)
    tplan = tpp.pack_pair_plan(*args, r_tile=1, **kw)
    ncc, lanes = jp.ncols, 2 * tplan.ln
    mask = (tpp.grouped_lane_mask(tplan, gp)[:, None, :] if gp else 1.0)

    def vec():
        v = rng.standard_normal((tplan.n_slots, 4, lanes)) * mask
        return v.astype(np.float32).reshape(-1, lanes)

    xv, yv, bv = vec(), vec(), vec()
    sc = tuple(rng.standard_normal((2, ncc, 4)))
    jprim = jpp.fused_primitives(None, None, jplan, ncc, jnp.asarray(bv),
                                 gp=gp)
    tprim = tpp.fused_primitives(None, tplan, ncc, torch.from_numpy(bv), gp)
    jx, jy = jnp.asarray(xv), jnp.asarray(yv)
    tx, ty = torch.from_numpy(xv), torch.from_numpy(yv)
    js = tuple(jnp.asarray(s) for s in sc)
    ts = tuple(torch.from_numpy(s) for s in sc)
    # the float64 sums: the port's primitives on float64 copies
    eprim = tpp.fused_primitives(None, tplan, ncc, torch.from_numpy(bv), gp)
    ex, ey = tx.double(), ty.double()
    cases = [(jprim.dotp(jx, jy), tprim.dotp(tx, ty), eprim.dotp(ex, ey)),
             (jprim.nrm2(jx), tprim.nrm2(tx), eprim.nrm2(ex)),
             (jprim.axpy(jy, jx, js), tprim.axpy(ty, tx, ts), None),
             (jprim.xpay(jy, js, jx), tprim.xpay(ty, ts, tx), None),
             (jprim.add_rhs(jy, None, -1.0), tprim.add_rhs(ty, None, -1.0),
              None)]
    for want, got, exact in cases:
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for i, (w, g) in enumerate(zip(want, got)):
            w, g = np.asarray(w), g.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype
            scale = np.max(np.abs(w))
            if exact is None:
                assert np.max(np.abs(g - w)) <= 1e-6 * scale
            else:
                e = (exact if isinstance(exact, tuple) else (exact,))[i]
                assert np.max(np.abs(g - e.numpy())) <= 1e-6 * scale
                assert np.max(np.abs(g - w)) <= 1e-5 * scale


# ------------------------------------------------------------ whole solves

def _solve_pair(monkeypatch, group, *, seed, x0=False, rhs_trivial=False):
    """The same 'c' solve through both packages' packed 'pairs' engines."""
    for k, v in (("TFQ_SOLVER_SUPER", "0"), ("TFQ_PAIRS_RESIDENT", "1"),
                 ("TFQ_PAIRS_TILEPIPE", "1"),
                 ("TFQ_PAIRS_COLGROUP", str(group))):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tsolver, "choose_group_size", lambda *a, **k: group)
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=12, lm=4, ln=4, ncols=4,
                                  x_fill=0.7, dtype=np.complex64)
    guess = None
    if x0:
        guess = (0.01 * (rng.standard_normal((x.nnzb, 4, 4))
                         + 1j * rng.standard_normal((x.nnzb, 4, 4)))
                 ).astype(np.complex64)
    js = jsolver.Solver(a, x, b, precision="c", engine="pairs")
    assert js.engine == "pairs" and js._pp_plan.resident
    assert (js._gp.group_size if js._gp else 1) == group
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, 4, 4)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="c", engine="pairs", plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    _same(ts._pp_plan, js._pp_plan, PLAN_FIELDS)
    infos = []
    for s in (js, ts):
        if guess is not None:
            s.set_matrix("X", guess)
        infos.append(s.solve(tolerance=1e-5, max_iterations=300,
                             rhs_trivial=rhs_trivial))
    jinfo, tinfo = infos
    assert tinfo.engine == "pairs"
    assert tinfo.return_status == jinfo.return_status == Status.SUCCESS
    assert abs(tinfo.iterations_needed - jinfo.iterations_needed) <= 2
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    assert got.dtype == np.complex64
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    # the same pair accounting (these cases take the same iteration count)
    assert tinfo.flops_performed == pytest.approx(jinfo.flops_performed)


@pytest.mark.parametrize("group,seed", [(1, 80), (4, 81)])
def test_packed_solve_matches_jax(monkeypatch, group, seed):
    _solve_pair(monkeypatch, group, seed=seed)


def test_packed_initial_guess_matches_jax(monkeypatch):
    _solve_pair(monkeypatch, 4, seed=82, x0=True)


def test_packed_trivial_rhs_matches_jax(monkeypatch):
    _solve_pair(monkeypatch, 1, seed=83, rhs_trivial=True)


def test_packed_flops_are_the_pair_accounting():
    from tfqmrgpu_tpu_torch import core

    a, x, b = make_random_problem(np.random.default_rng(84), mb=10, lm=4,
                                  ln=4, ncols=4, dtype=np.complex64)
    s = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                  device="cpu")
    info = s.solve(tolerance=1e-5, max_iterations=300)
    assert info.return_status == Status.SUCCESS
    p = s.plan
    want = (info.iterations_needed
            * core.flops_per_iteration(p.n_pairs, p.nnzb_x, 4, 4)
            + info.n_probes * core.flops_per_probe(p.n_pairs, p.nnzb_x, 4, 4))
    assert info.flops_performed == want

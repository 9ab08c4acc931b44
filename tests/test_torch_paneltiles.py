"""The host tables of the staged panel kernels K2 and K3
(``tfqmrgpu_tpu_torch/ops/paneltiles.py``) on the CPU: the depth-major A
layout, the unit tables (tiles side by side, each X block of their union
once), the work list, and the plain walker over them.

The walker is held bit for bit against the wrappers' plain versions on
integer-valued data (every sum exact in float32, whatever its order), within
1e-6 relative on random data (FP32 sums in another order), and within 1e-4
against the TPU kernels ``kernel_tile_pipe`` (K2) and K3 run in interpret
mode at precision 'highest', the gates of tests/test_torch_pairpack.py and
tests/test_torch_rowtile.py.  The Hopper kernels that run these tables are
tested on the card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_problem
from test_pairpanel import _bsr_pair_plan
from test_torch_panel import _plans
from tfqmrgpu_tpu.ops import pairpanel as jpp
from tfqmrgpu_tpu.ops import pallas_spmm as jrt
from tfqmrgpu_tpu_torch import _build
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp
from tfqmrgpu_tpu_torch.ops import pallas_spmm as trt
from tfqmrgpu_tpu_torch.ops import paneltiles as pt
from tfqmrgpu_tpu_torch.ops.panel import PanelLayout

torch.set_num_threads(2)
f32 = np.float32


def _k2_case(seed, lm, ln, r_tile, mb=10, ncols=2, integer=False):
    """A packed plan, its JAX-layout panels and a fused X panel."""
    rng = np.random.default_rng(seed)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=mb, ncols=ncols, lm=lm, ln=ln)
    plan = tpp.pack_pair_plan(pa, px, py, nx, nx, lm, ln, r_tile=r_tile)
    if integer:
        a = rng.integers(-3, 4, (2, na, lm, lm)).astype(f32)
        x = rng.integers(-3, 4, (2, nx, lm, ln)).astype(f32)
    else:
        a = rng.standard_normal((2, na, lm, lm)).astype(f32)
        x = rng.standard_normal((2, nx, lm, ln)).astype(f32)
    panels = tpp.build_a_panels(plan, a[0], a[1])
    return plan, panels, tpp.permute_x(plan, x[0], x[1]), (pa, px, py, nx)


def _k2_walk(plan, panels, fused, bm, bn, slots=7, union=True):
    """K2's product by the walker: the fused panel, and the write counts."""
    c = plan.ln
    tables = pt.unit_tables(plan.xloc, plan.kcount, plan.r_tile * plan.lm, bm,
                            union)
    items, cta_start = pt.work_list(tables, c, bn, slots)
    x = torch.from_numpy(fused)
    y_re, y_im, writes = pt.walk(
        tables, items, pt.depth_major(torch.from_numpy(panels)),
        x[:, :c].contiguous(), x[:, c:].contiguous(), plan.lm,
        plan.n_slots * plan.lm, bn)
    return torch.cat([y_re, y_im], dim=1), writes, tables


def _k3_case(seed, mb, lm, ln, ncols, r_tile, integer=False):
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols)
    _, tp = _plans(a, x, b, lm, ln)
    lay = PanelLayout.from_plan(tp)
    pack = trt.pack_row_tiles(tp.rowptr_a, tp.colind_a, mb, lm, r_tile)
    if integer:
        are, aim = rng.integers(-3, 4, (2,) + a.data.shape).astype(f32)
        xv = rng.integers(-3, 4, (2, tp.nnzb_x, lm, ln)).astype(f32)
    else:
        are, aim = a.data.real.astype(f32), a.data.imag.astype(f32)
        xv = rng.standard_normal((2, tp.nnzb_x, lm, ln)).astype(f32)
    panels = [trt.build_a_panels(pack, v) for v in (are, aim)]
    tm = trt.RowTileMultiply(pack, *(torch.from_numpy(v) for v in panels),
                             lay.mask, ln)
    xp = tuple(torch.from_numpy(lay.pack_x(v)) for v in xv)
    return tm, xp, pack, (are, aim), lay


def _k3_walk(tm, xp, bm, bn, slots=7, union=None):
    """K3's product by the walker, masked: over the wrapper's own tables,
    or those of another CTA height and X staging."""
    tables = (tm.units if union is None else
              pt.unit_tables(tm.xcols.numpy(), tm.kcount, tm.rlm, bm, union))
    items, _ = pt.work_list(tables, tm.c, bn, slots)
    a_dm = pt.depth_major(tm.a_fused)
    y_re, y_im, writes = pt.walk(
        tables, items, a_dm, xp[0].reshape(tm.nr, tm.c),
        xp[1].reshape(tm.nr, tm.c), tm.lm, tm.nr, bn)
    keep = torch.from_numpy(np.repeat(np.repeat(
        tm.mask.numpy(), tm.lm, axis=0), tm.ln, axis=1).astype(f32))
    shape = (tm.nr, tm.ncc, tm.ln)
    return (y_re * keep).reshape(shape), (y_im * keep).reshape(shape), writes


# ----------------------------------------------------------- the A layout

@pytest.mark.parametrize("r_tile", [1, 2])
def test_depth_major_is_the_jax_layout_transposed(r_tile):
    plan, panels, _, _ = _k2_case(1, 4, 8, r_tile)
    a = np.random.default_rng(1).standard_normal(
        (2, int(plan.pair_a.max()) + 1, 4, 4)).astype(f32)
    for p in (panels, jpp.build_a_panels(plan, a[0], a[1])):
        dm = pt.depth_major(torch.from_numpy(p))
        assert dm.is_contiguous()
        assert dm.shape == (plan.ntiles, plan.ku * 4, 2 * r_tile * 4)
        assert np.array_equal(dm.numpy(), np.swapaxes(p, 1, 2))
    # K3 keeps re rows over im rows the same way
    tm, _, pack, (are, aim), _ = _k3_case(2, 9, 4, 4, 2, r_tile)
    dm = pt.depth_major(tm.a_fused)
    assert np.array_equal(dm.numpy()[:, :, :tm.rlm], np.swapaxes(
        jrt.build_a_panels(pack, are), 1, 2))
    assert np.array_equal(dm.numpy()[:, :, tm.rlm:], np.swapaxes(
        jrt.build_a_panels(pack, aim), 1, 2))


# ------------------------------------------------------------ unit tables

@pytest.mark.parametrize("nt", [1, 2, 4, 8])
@pytest.mark.parametrize("r_tile", [1, 2])
def test_unit_tables_hold_every_tile_slot_ascending(nt, r_tile):
    plan, _, _, _ = _k2_case(10 + nt, 4, 4, r_tile, mb=13, ncols=3)
    rlm = r_tile * 4
    t = pt.unit_tables(plan.xloc, plan.kcount, rlm, nt * rlm, union=True)
    assert (t.nt, t.row_blocks) == (nt, 1)
    assert t.ngroups == -(-plan.ntiles // nt)
    assert t.ksteps == t.ucount.max() and t.ucount.min() >= 1
    for g in range(t.ngroups):
        u = t.uslot[g, :t.ucount[g], 0]
        assert np.all(t.uslot[g] == t.uslot[g, :, :1])  # one X block a step
        assert np.all(np.diff(u) > 0)                  # ascending, no repeat
        assert np.all(t.ukidx[g, t.ucount[g]:] == -1)
        seen = set()
        for n in range(nt):
            tile = g * nt + n
            steps = np.flatnonzero(t.ukidx[g, :, n] >= 0)
            if tile >= plan.ntiles:
                assert steps.size == 0
                continue
            own = plan.xloc[tile, :plan.kcount[tile]]
            # every slot of the tile, in the tile's own order
            assert np.array_equal(t.ukidx[g, steps, n],
                                  np.arange(own.shape[0]))
            assert np.array_equal(u[steps], own)
            seen.update(own.tolist())
        assert seen == set(u.tolist())                 # nothing but the union


@pytest.mark.parametrize("nt", [1, 2, 8])
def test_unit_tables_with_a_slab_for_each_tile(nt):
    """Without the union, step s is every tile's own s-th block."""
    plan, _, _, _ = _k2_case(15 + nt, 4, 4, 1, mb=13, ncols=3)
    t = pt.unit_tables(plan.xloc, plan.kcount, 4, nt * 4, union=False)
    assert (t.nt, t.union) == (nt, False)
    assert t.staged_x_blocks == int(plan.kcount.sum())
    for g in range(t.ngroups):
        tiles = range(g * nt, min((g + 1) * nt, plan.ntiles))
        assert t.ucount[g] == max(plan.kcount[tile] for tile in tiles)
        for n in range(nt):
            k = plan.kcount[g * nt + n] if g * nt + n < plan.ntiles else 0
            assert np.array_equal(t.ukidx[g, :k, n], np.arange(k))
            assert np.all(t.ukidx[g, k:, n] == -1)
            assert np.array_equal(t.uslot[g, :k, n],
                                  plan.xloc[g * nt + n, :k] if k else [])
    # fewer steps than the union's wherever tiles differ
    u = pt.unit_tables(plan.xloc, plan.kcount, 4, nt * 4, union=True)
    assert np.all(t.ucount <= u.ucount)
    assert (t.ucount.sum() < u.ucount.sum()) == (nt > 1)


@pytest.mark.parametrize("union", [True, False])
def test_unit_tables_of_tall_tiles_and_bad_lists(union):
    plan, _, _, _ = _k2_case(20, 4, 4, 4)              # rlm 16 over CTAs of 8
    t = pt.unit_tables(plan.xloc, plan.kcount, 16, 8, union)
    assert (t.nt, t.row_blocks, t.ngroups) == (1, 2, plan.ntiles)
    assert np.array_equal(t.ucount, plan.kcount)
    assert t.staged_x_blocks == 2 * int(plan.kcount.sum())
    empty = pt.unit_tables(np.zeros((3, 2), np.int32), np.zeros(3, np.int32),
                           4, 8, union)
    assert np.all(empty.ucount == 1) and np.all(empty.ukidx == -1)
    with pytest.raises(ValueError, match="ascending"):
        pt.unit_tables(np.array([[2, 1]]), np.array([2]), 4, 4, union)
    with pytest.raises(ValueError, match="multiples of 4"):
        pt.unit_tables(plan.xloc, plan.kcount, 6, 8, union)


# -------------------------------------------------------------- work list

@pytest.mark.parametrize("slots", [1, 7, 132, 264])
@pytest.mark.parametrize("mb", [5, 7, 8, 23])
def test_work_list_covers_every_output_once(slots, mb):
    """Unit counts below, at and above a multiple of the slots (7 units x 3
    column blocks against 7 slots; 5, 8 and 23 units either side)."""
    plan, panels, fused, _ = _k2_case(30 + mb, 4, 10, 1, mb=mb, ncols=1,
                                      integer=True)
    assert plan.ntiles == mb
    tables = pt.unit_tables(plan.xloc, plan.kcount, 4, 4, union=True)
    items, cta_start = pt.work_list(tables, plan.ln, 4, slots)
    n = mb * 3                                         # 10 lanes: 4 + 4 + 2
    assert items.shape == (n, 4) and items.dtype == np.int32
    assert len({tuple(i) for i in items.tolist()}) == n
    runs = np.diff(cta_start)
    assert cta_start[0] == 0 and cta_start[-1] == n and runs.min() >= 1
    assert runs.max() <= pt.MAX_RUN
    assert len(runs) == max(min(n, slots), -(-n // pt.MAX_RUN))
    # dealt by steps: no CTA ends more than one unit's steps after another
    steps = tables.ucount[items[:, 0]]
    load = np.add.reduceat(steps, cta_start[:-1])
    assert load.max() - load.min() <= steps.max()
    for b in range(len(runs)):                         # in the order of tiles
        mine = items[cta_start[b]:cta_start[b + 1], [0, 2]].tolist()
        assert mine == sorted(mine)
    y, writes, _ = _k2_walk(plan, panels, fused, 4, 4, slots)
    assert np.all(writes == 1)
    want = tpp.PairPanelMultiply(plan, torch.from_numpy(panels)).plain(
        torch.from_numpy(fused))
    assert torch.equal(y, want)                        # integer data: exact


@pytest.mark.parametrize("slots", [5, 12, 264])
def test_work_list_deals_by_steps(slots):
    """A stretch of long units (a band's wrap-around) does not pile up on a
    few CTAs, and units of equal cost go round in turn."""
    ku, ntiles = 22, 60
    kcount = np.full(ntiles, 12)
    kcount[20:30] = ku                                 # ten long tiles in a row
    xloc = np.tile(np.arange(ku), (ntiles, 1))
    tables = pt.unit_tables(xloc, kcount, 8, 8, union=True)
    items, cta_start = pt.work_list(tables, 16, 4, slots)
    n = ntiles * 4
    assert sorted(map(tuple, items.tolist())) == sorted(
        (t, 0, j, 0) for t in range(ntiles) for j in (0, 4, 8, 12))
    steps = tables.ucount[items[:, 0]]
    load = np.add.reduceat(steps, cta_start[:-1])
    nctas = min(n, slots)
    assert len(load) == nctas
    assert load.max() - load.min() <= ku
    assert load.max() <= -(-int(steps.sum()) // nctas) + ku - 1
    long_ones = np.add.reduceat((steps == ku).astype(int), cta_start[:-1])
    assert long_ones.max() - long_ones.min() <= 1      # spread over the CTAs
    # equal costs: item i goes to CTA i mod nctas
    flat = pt.unit_tables(xloc, np.full(ntiles, 12), 8, 8, union=True)
    items, cta_start = pt.work_list(flat, 16, 4, slots)
    assert np.diff(cta_start).max() - np.diff(cta_start).min() <= 1
    first = items[cta_start[:-1]]
    assert first[:, [0, 2]].tolist() == [[i // 4, 4 * (i % 4)]
                                         for i in range(nctas)]


def test_work_list_splits_runs_too_long_for_a_cta():
    plan, _, _, _ = _k2_case(40, 4, 4, 1, mb=40, ncols=1)
    tables = pt.unit_tables(plan.xloc, plan.kcount, 4, 4, union=False)
    items, cta_start = pt.work_list(tables, 4, 4, slots=1, max_run=16)
    assert len(cta_start) - 1 == 3 and np.diff(cta_start).max() <= 16
    with pytest.raises(ValueError):
        pt.work_list(tables, 4, 4, slots=0)


# ------------------------------------------------------------- K2's walker

@pytest.mark.parametrize("union", [True, False])
@pytest.mark.parametrize("lm,ln,r_tile,bm,bn", [
    (4, 4, 1, 64, 64), (4, 4, 1, 8, 4), (4, 10, 2, 16, 8), (4, 5, 4, 8, 4),
    (8, 8, 1, 32, 8), (8, 9, 2, 32, 4),
])
def test_k2_walker_equals_plain_bit_for_bit(lm, ln, r_tile, bm, bn, union):
    plan, panels, fused, _ = _k2_case(50 + ln + r_tile, lm, ln, r_tile,
                                      integer=True)
    y, writes, tables = _k2_walk(plan, panels, fused, bm, bn, union=union)
    tm = tpp.PairPanelMultiply(plan, torch.from_numpy(panels))
    assert np.all(writes == 1)
    assert torch.equal(y, tm.plain(torch.from_numpy(fused)))
    # the wrapper's own tables are those of the kernel's CTA shape
    assert tm.units.bm == pt.cta_shape(plan.ln)[0]
    assert tm.units.union == (pt.cta_shape(plan.ln) == pt.WIDE)
    # random data: the same sums in another order
    plan, panels, fused, _ = _k2_case(60 + ln + r_tile, lm, ln, r_tile)
    y, _, _ = _k2_walk(plan, panels, fused, bm, bn, union=union)
    want = tpp.PairPanelMultiply(plan, torch.from_numpy(panels)).plain(
        torch.from_numpy(fused))
    assert float((y - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("lm,ln,r_tile", [(4, 4, 1), (4, 4, 2), (4, 128, 1)])
def test_k2_walker_matches_tile_pipe_interpret(monkeypatch, lm, ln, r_tile):
    monkeypatch.setenv("TFQ_PAIRS_TILEPIPE", "1")
    plan, panels, fused, (pa, px, py, nx) = _k2_case(70 + ln + r_tile, lm, ln,
                                                     r_tile)
    jplan = jpp.pack_pair_plan(pa, px, py, nx, nx, lm, ln, r_tile=r_tile,
                               resident=True)
    assert jpp.use_tile_pipe(jplan, "highest")
    jm = jpp.make_pairpanel_multiply(jplan, jnp.asarray(panels),
                                     precision="highest", interpret=True)
    want = np.asarray(jm(jnp.asarray(fused)))[: plan.n_slots * lm]
    bm, bn = pt.cta_shape(ln)
    y, writes, _ = _k2_walk(plan, panels, fused, bm, bn, slots=264,
                            union=(bm, bn) == pt.WIDE)
    assert np.all(writes == 1)
    assert np.max(np.abs(y.numpy() - want)) <= 1e-4 * np.max(np.abs(want))


# ------------------------------------------------------------- K3's walker

@pytest.mark.parametrize("seed,mb,lm,ln,ncols,r_tile", [
    (80, 12, 4, 8, 3, 1), (81, 13, 4, 4, 2, 4), (82, 10, 8, 8, 2, 3),
    (83, 9, 8, 10, 3, 2),
])
def test_k3_walker_matches_plain_and_tpu_kernel(seed, mb, lm, ln, ncols,
                                                r_tile):
    tm, xp, pack, _, _ = _k3_case(seed, mb, lm, ln, ncols, r_tile,
                                  integer=True)
    y_re, y_im, writes = _k3_walk(tm, xp, *pt.cta_shape(tm.c))
    want = tm.plain(xp)
    assert np.all(writes == 1)
    assert torch.equal(y_re, want[0]) and torch.equal(y_im, want[1])

    tm, xp, pack, (are, aim), lay = _k3_case(seed, mb, lm, ln, ncols, r_tile)
    mask4 = lay.mask[:, None, :, None].astype(f32)
    jm = jrt.bsr_panel_multiply(
        jnp.asarray(jrt.build_a_panels(pack, are)),
        jnp.asarray(jrt.build_a_panels(pack, aim)), jnp.asarray(pack.xcols),
        jnp.asarray(mask4), mb, lm, lay.ncc, ln, interpret=True,
        precision="highest", t_step=1)
    want = [np.asarray(v) for v in jm(tuple(jnp.asarray(p.numpy())
                                            for p in xp))]
    scale = max(np.max(np.abs(w)) for w in want)
    for bm, bn, union in ((*pt.cta_shape(tm.c), None), (8, 4, True),
                          (16, 4, False)):
        got = _k3_walk(tm, xp, bm, bn, union=union)
        assert np.all(got[2] == 1)
        for g, w in zip(got[:2], want):
            assert np.max(np.abs(g.numpy() - w)) <= 1e-4 * scale


# ------------------------------------------------------- the CPU never builds

def test_cpu_wrappers_keep_tables_and_never_build(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    plan, panels, fused, _ = _k2_case(90, 4, 4, 2)
    tm = tpp.PairPanelMultiply(plan, torch.from_numpy(panels))
    assert not hasattr(tm, "a_dm") and not hasattr(tm, "launch_tables")
    assert tm.units.nt == pt.NARROW[0] // 8
    before = tpp.PairPanelMultiply.launches
    assert torch.equal(tm(torch.from_numpy(fused)),
                       tm.plain(torch.from_numpy(fused)))
    assert tpp.PairPanelMultiply.launches == before
    km, xp, _, _, _ = _k3_case(91, 9, 4, 4, 2, 2)
    assert not hasattr(km, "a_dm") and km.units.nt == pt.NARROW[0] // 8
    before = trt.RowTileMultiply.launches
    assert torch.equal(km(xp)[0], km.plain(xp)[0])
    assert trt.RowTileMultiply.launches == before
    assert pt.cta_shape(64) == pt.WIDE and pt.cta_shape(63) == pt.NARROW

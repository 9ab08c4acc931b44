"""K1's tile schedule ('z'): the plan-time tables of ``ops/pairpanel.py``.

The schedule must run every pair of the plan exactly once, write every Y
block from one tile, and stage each A and X block once per tile; its plain
walker (``spmm_schedule``) is held against the JAX package's f64 pair-list
product to 1e-12 and against the TPU kernel K1 itself, in interpret mode,
in f32 to 1e-4.  The kernel that runs the schedule is tested on the card
by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import golden_class_patterns
from conftest import make_random_problem
from test_torch_spmm import _banded, _maxdev, _planes, _problem
from tfqmrgpu_tpu.ops import blocksparse as jbs
from tfqmrgpu_tpu_torch import ALLOWED_BLOCK_SIZES, _build, create_plan
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.generator import generate_fd_problem
from tfqmrgpu_tpu_torch.ops import pairpanel as pp

torch.set_num_threads(2)

GOLDEN_PAIR_BYTES = 16 * 2 * 32 * 32   # one A and one X block of 'z', 32 x 32


def _plan(case):
    """(plan, LM, LN) of a random plan at one block size, of FD rtb=6.75,
    or of the golden class."""
    if case == "fd6.75":
        fd = generate_fd_problem(rtb=6.75)
        return create_plan(fd.a, fd.x, fd.b, device="cpu"), 8, 8
    if case == "golden":
        return create_plan(*golden_class_patterns(), device="cpu"), 32, 32
    lm, ln = case
    rng = np.random.default_rng(lm * 100 + ln)
    a, x, b = make_random_problem(rng, mb=14, lm=lm, ln=ln, ncols=5)
    plan = create_plan(*[TBsr(m.nrows, m.ncols, m.rowptr, m.colind, None,
                              m.name) for m in (a, x, b)], device="cpu")
    return plan, lm, ln


@pytest.mark.parametrize("case", list(ALLOWED_BLOCK_SIZES) + ["fd6.75",
                                                              "golden"],
                         ids=str)
def test_schedule_runs_every_pair_once(case):
    plan, lm, ln = _plan(case)
    want = sorted(zip(plan.pair_y().tolist(), plan.pairs[:, 0].tolist(),
                      plan.pairs[:, 1].tolist()))
    rule = pp.tile_schedule(plan, lm, ln)
    grids = pp.warp_grids(lm, ln)
    assert (rule.warps_m, rule.warps_n) in grids
    for grid in grids:
        s = pp.tile_schedule(plan, lm, ln, grid)
        ia, ix, iy = s.products()
        assert sorted(zip(iy.tolist(), ia.tolist(), ix.tolist())) == want
        ys = s.tile_y[s.tile_y >= 0]
        assert np.array_equal(np.sort(ys), np.arange(plan.nnzb_x))
        for t in range(s.ntiles):           # each block staged once a tile
            steps = slice(s.tile_steps[t], s.tile_steps[t + 1])
            for ids in (s.step_a[steps], s.step_x[steps]):
                ids = ids[ids >= 0]
                assert np.unique(ids).shape[0] == ids.shape[0]
        bits = (s.step_a >= 0) * (1 << np.arange(s.rows, dtype=np.uint64))
        assert np.array_equal(s.step_mask, bits.sum(axis=1).astype(np.uint64))
        assert s.staged_bytes == 16 * (
            np.count_nonzero(s.step_a >= 0) * lm * lm
            + np.count_nonzero(s.step_x >= 0) * lm * ln)


@pytest.mark.parametrize("grid", pp.warp_grids(32, 32), ids=str)
def test_golden_staged_bytes(grid):
    """A golden-class tile of R x W blocks (A row i holds block columns
    i .. i+10 of 281, X is full over 16 columns) stages the 11*R A blocks
    of its rows and the (10 + R)*W X blocks of their 10 + R columns: below
    the 1.62 GB that one pair at a time stages."""
    plan, _, _ = _plan("golden")
    s = pp.tile_schedule(plan, 32, 32, grid)
    r, w = s.rows, s.cols
    blocks = 0
    for i0 in range(0, 281, r):
        rows = min(r, 281 - i0)
        blocks += (16 // w) * (11 * rows + (10 + rows) * w)
    assert (s.ntiles, s.staged_bytes) == (
        -(-281 // r) * (16 // w), blocks * GOLDEN_PAIR_BYTES // 2)
    assert s.staged_bytes <= plan.n_pairs * GOLDEN_PAIR_BYTES
    assert plan.n_pairs * GOLDEN_PAIR_BYTES == 1_620_574_208


def test_golden_rule_picks_four_warp_tiles():
    """Four-warp tiles give 2 * 132 tiles or more, and of those grids 1 x 4
    runs the fewest steps (11 per tile: no padded A slots)."""
    plan, _, _ = _plan("golden")
    s = pp.tile_schedule(plan, 32, 32)
    assert (s.warps_m, s.warps_n, s.rows, s.cols) == (1, 4, 1, 4)
    assert (s.ntiles, s.nsteps) == (281 * 4, 281 * 4 * 11)
    assert s.staged_bytes == 1124 * 55 * GOLDEN_PAIR_BYTES // 2
    fd, _, _ = _plan("fd6.75")
    f = pp.tile_schedule(fd, 8, 8)            # too few rows for 4 warps
    assert (f.warps_m, f.warps_n) == (1, 1)


@pytest.mark.parametrize("sm_count,warps", [(114, 4), (568, 4), (569, 2),
                                            (1128, 2), (1129, 1)])
def test_golden_rule_reads_the_sm_count(sm_count, warps):
    """The rule fills ``sm_count`` SMs twice before it makes tiles larger:
    the golden class has at most 1136 tiles of four warps (4 x 1), 2256 of
    two (2 x 1) and 4496 of one."""
    plan, _, _ = _plan("golden")
    s = pp.tile_schedule(plan, 32, 32, sm_count=sm_count)
    assert s.warps_m * s.warps_n == warps


@pytest.mark.parametrize("seed,mb,lm,ln,ncols", [
    (0, 12, 4, 8, 3), (1, 16, 8, 8, 2), (2, 10, 8, 10, 3), (3, 9, 4, 5, 4),
    (6, 8, 16, 16, 3), (7, 6, 32, 32, 5),
])
def test_spmm_schedule_matches_jax_pairs_f64(seed, mb, lm, ln, ncols):
    plan, a, xv = _problem(seed, mb, lm, ln, ncols)
    jr, ji = jbs.spmm_pairs((jnp.asarray(a.real), jnp.asarray(a.imag)),
                            (jnp.asarray(xv.real), jnp.asarray(xv.imag)),
                            jnp.asarray(plan.pairs[:, 0].numpy()),
                            jnp.asarray(plan.pairs[:, 1].numpy()),
                            jnp.asarray(plan.pair_y().numpy().astype(np.int32)),
                            plan.nnzb_x)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    for grid in pp.warp_grids(lm, ln):
        yr, yi = pp.spmm_schedule(_planes(a), _planes(xv),
                                  pp.tile_schedule(plan, lm, ln, grid),
                                  plan.nnzb_x)
        assert yr.dtype == torch.float64
        assert _maxdev(yr.numpy() + 1j * yi.numpy(), want) <= 1e-12, grid


@pytest.mark.parametrize("lm,ln,ncols", [(4, 4, 2), (8, 8, 3)])
def test_spmm_schedule_matches_tpu_kernel_interpret_f32(lm, ln, ncols):
    from tfqmrgpu_tpu.ops import pairpanel as jpp

    plan, row_of_x, av, xv = _banded(mb=10, ncols=ncols, lm=lm, ln=ln, seed=5)
    pplan = jpp.pack_pair_plan(plan.pairs[:, 0].numpy(),
                               plan.pairs[:, 1].numpy(),
                               plan.pair_y().numpy(), plan.nnzb_x,
                               plan.nnzb_x, lm, ln, r_tile=1, row_of=row_of_x,
                               col_of=plan.colindx.numpy())
    f32 = np.float32
    panels = jnp.asarray(jpp.build_a_panels(pplan, av.real.astype(f32),
                                            av.imag.astype(f32)))
    k1 = jpp.make_pairpanel_multiply(pplan, panels, precision="highest",
                                     interpret=True)
    xf = jnp.asarray(jpp.permute_x(pplan, xv.real.astype(f32),
                                   xv.imag.astype(f32)))
    yre, yim = jpp.unpermute_y(pplan, np.asarray(k1(xf)))
    want = yre + 1j * yim
    for grid in pp.warp_grids(lm, ln):
        yr, yi = pp.spmm_schedule(_planes(av, torch.float32),
                                  _planes(xv, torch.float32),
                                  pp.tile_schedule(plan, lm, ln, grid),
                                  plan.nnzb_x)
        assert _maxdev(yr.numpy() + 1j * yi.numpy(), want) <= 1e-4, grid


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_cpu_pair_plan_multiply_never_builds(monkeypatch, dtype):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    plan, a, xv = _problem(8, 10, 8, 8, 3)
    mult = pp.PairPlanMultiply(plan, *_planes(a, dtype), 8)
    assert (mult.schedule is not None) == (dtype == torch.float64)
    before = pp.PairPlanMultiply.launches
    x = _planes(xv, dtype)
    got = mult(x)
    assert pp.PairPlanMultiply.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, mult.plain(x)))


def test_schedule_rejects_what_it_cannot_run():
    plan, a, _ = _problem(9, 10, 8, 8, 3)
    tables = (plan.rowptr_x, plan.colindx.numpy(), plan.starts.numpy())
    pairs = plan.pairs.numpy()
    with pytest.raises(ValueError, match="warp grid"):
        pp.build_tile_schedule(*tables, pairs, 8, 8, (5, 1))
    # the golden table less one pair of Y block (0, 0), A(0, 5) . X(5, 0):
    # a 2 x 2 tile stages A(0, 5) for Y (0, 1) and X(5, 0) for Y (1, 0), so
    # its dense step would add the missing product
    golden, _, _ = _plan("golden")
    keep = np.arange(golden.n_pairs) != 5
    py = golden.pair_y().numpy()[keep]
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        py, minlength=golden.nnzb_x))])
    with pytest.raises(ValueError, match="intersection"):
        pp.build_tile_schedule(golden.rowptr_x, golden.colindx.numpy(),
                               starts, golden.pairs.numpy()[keep], 32, 32,
                               (2, 2))
    pp.build_tile_schedule(golden.rowptr_x, golden.colindx.numpy(), starts,
                           golden.pairs.numpy()[keep], 32, 32, (1, 1))
    with pytest.raises(ValueError, match="warp grid"):
        pp.PairPlanMultiply(plan, *_planes(a), 8, grid=(5, 1))
    with pytest.raises(ValueError, match="'z' kernel only"):
        pp.PairPlanMultiply(plan, *_planes(a, torch.float32), 8, grid=(1, 1))
    mult = pp.PairPlanMultiply(plan, *_planes(a), 8, grid=(2, 1))
    assert (mult.schedule.warps_m, mult.schedule.warps_n) == (2, 1)

"""The FD generator's 64-point blocks (block_edge 4, dim 3; LM = LN = 64,
the largest of the reference's block sizes) on the CPU, against the
benchmark's plain reference (``benchmark/reference``: plain torch, nothing
of the port or of JAX).

At a small size (rsb 4.75, rtb 4.75: 25 block rows, 7 source blocks, 133
pairs) with a seeded random potential V and three seeded complex energies,
two of them inside the band [0, 19.505]:

* the port's ``Solver`` ('pairs', K1's plain version, the engine the
  benchmark cell runs, and 'auto', which takes 'dense' at this size) against
  the reference's complex128 tfQMR: X within ``XDEV`` and the iterations
  within ``ITER_GAP``; the reference in complex64 misses ``XDEV``;
* the product over X's pattern against the reference's product;
* K1's tile schedule at (64, 64): one warp grid, (2, 2), one Y block a
  tile, and its plain walk equal to the pair product;

and, at the whole pattern of the benchmark's ``fd64_z`` on the host only,
'auto' resolving to 'pairs' and the schedule's figures.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import tfqmrgpu_tpu_torch as tt
from benchmark import pool, problems
from benchmark.problems import fd
from benchmark.reference import tfqmr
from benchmark.reference.operator import Operator
from benchmark.reference.solver import ReferenceSolver
from tfqmrgpu_tpu_torch.ops import pairpanel as pp
from tfqmrgpu_tpu_torch.ops.blocksparse import spmm_pairs

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark/configs/fd64_z.json").read_text())
SMALL = dict(CONFIG, rsb=4.75, rtb=4.75, potential_seed=64)
TOL, MAXIT = CONFIG["tolerance"], CONFIG["max_iterations"]
# E = (real, imag) drawn once: below the band, near its bottom, inside it
_RNG = np.random.default_rng(6464)
ENERGIES = [complex(_RNG.uniform(lo, hi), _RNG.uniform(0.2, 2.0))
            for lo, hi in ((-20.0, -1.0), (-1.0, 1.0), (1.0, 19.0))]
# max |X - X_ref| / max |X_ref|.  Both solves stop at a relative residual
# at or below 1e-9 on the same recurrences, and differ only by the order of
# their sums: 5e-13, 2e-11 and 2e-10 at the three energies.  The
# reference in complex64 stops at 2e-4 to 8e-3 (or not at all), so the
# tolerance tells complex128 from complex64 by four orders.
XDEV = 1e-8
# |iterations - the reference's|.  Inside the band the recurrences amplify
# a rounding difference about 1e7-fold in 30 iterations, so a probe's true
# residual lands on either side of the tolerance by the order of the sums:
# at the in-band energy both the port's layouts take 143 iterations where
# the reference takes 141, and 0 apart at the other two.
ITER_GAP = 2


@pytest.fixture(scope="module")
def small():
    return problems.build(SMALL, 0, "cpu")


def _bsrs(p, a=None):
    return (tt.Bsr(p.nrows, p.nrows, p.a_rowptr, p.a_colind, a, "A"),
            tt.Bsr(p.nrows, p.ncols, p.x_rowptr, p.x_colind, None, "X"),
            tt.Bsr(p.nrows, p.ncols, p.b_rowptr, p.b_colind, p.b_data, "B"))


def _a_at(p, energy):
    return pool.make_pool(p, np.array([-energy]))[0]


def _reference(p, a):
    op = Operator(p, a, "cpu")
    return op, tfqmr.solve(op, op.rhs(p.b_data), TOL, MAXIT)


def _xdev(x, ref_x):
    x = torch.from_numpy(np.ascontiguousarray(x))
    return float((x - ref_x).abs().max() / ref_x.abs().max())


def test_small_pattern_sizes(small):
    assert (small.nrows, small.ncols, small.lm, small.ln) == (25, 7, 64, 64)
    assert small.nnzb == {"A": 97, "X": 49, "B": 7}
    assert ENERGIES[2].real > 0.0 and ENERGIES[1].real > -0.25


# 'pairs' at every energy; 'auto' ('dense' here, whose CPU product is a
# dense 1,600-row matmul, ~0.3 s an iteration) at the two that take under
# 40 iterations
SOLVES = [("pairs", k) for k in range(len(ENERGIES))] + [("auto", 0),
                                                         ("auto", 1)]


@pytest.mark.parametrize("engine,k", SOLVES)
def test_solve_matches_the_reference(small, engine, k):
    a = _a_at(small, ENERGIES[k])
    _, ref = _reference(small, a)
    assert ref.status == tfqmr.CONVERGED
    s = tt.Solver(*_bsrs(small, a), precision="z", engine=engine,
                  device="cpu")
    assert s.engine == ("dense" if engine == "auto" else "pairs")
    info = s.solve(tolerance=TOL, max_iterations=MAXIT)
    assert info.return_status == 0
    assert abs(info.iterations_needed - ref.iterations) <= ITER_GAP
    assert _xdev(s.get_matrix("X"), ref.x) <= XDEV


def test_complex64_misses_the_x_tolerance(small):
    a = _a_at(small, ENERGIES[0])
    _, ref = _reference(small, a)
    c = ReferenceSolver(small, a, SMALL, "cpu", torch.complex64)
    assert c.solve(TOL, MAXIT).status == tfqmr.CONVERGED
    assert _xdev(c.get_x(), ref.x) > 100 * XDEV


def _random_x(p, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p.nnzb["X"], 64, 64, 2)) @ [1.0, 1.0j]


def test_product_matches_the_reference(small):
    a = _a_at(small, ENERGIES[2])
    op = Operator(small, a, "cpu")
    x = _random_x(small, 1)
    want = op(torch.from_numpy(x))
    s = tt.Solver(*_bsrs(small, a), precision="z", engine="pairs",
                  device="cpu")
    mult = s._multiply
    assert isinstance(mult, pp.PairPlanMultiply)
    got = mult((torch.from_numpy(x.real.copy()),
                torch.from_numpy(x.imag.copy())))
    dev = torch.complex(*got) - want
    assert float(dev.abs().max() / want.abs().max()) <= 1e-12


def test_tile_schedule_at_64(small):
    """One warp grid fits (64, 64): a tile is one Y block, each step stages
    one A and one X block, so every pair stages 2 x 64 KB."""
    assert pp.warp_grids(64, 64) == [(2, 2)]
    plan = tt.create_plan(*_bsrs(small), device="cpu")
    sched = pp.tile_schedule(plan, 64, 64)
    pairs = int(plan.pairs.shape[0])
    assert pairs == 133
    assert (sched.warps_m, sched.warps_n, sched.rows, sched.cols) == (2, 2,
                                                                      1, 1)
    assert (sched.ntiles, sched.nsteps) == (plan.nnzb_x, pairs)
    assert sched.staged_bytes == 2 * 16 * 64 * 64 * pairs
    rng = np.random.default_rng(2)
    a = [torch.from_numpy(rng.standard_normal((plan.nnzb_a, 64, 64)))
         for _ in range(2)]
    x = [torch.from_numpy(rng.standard_normal((plan.nnzb_x, 64, 64)))
         for _ in range(2)]
    walked = pp.spmm_schedule(a, x, sched, plan.nnzb_x)
    py = plan.pair_y()
    want = spmm_pairs(a, x, plan.pairs[:, 0].long(), plan.pairs[:, 1].long(),
                      py, plan.nnzb_x)
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g - w).abs().max())
               for g, w in zip(walked, want)) <= 1e-12 * scale


def test_the_cells_pattern_takes_pairs_on_the_host():
    """At the whole fd64_z pattern (461 block rows, 21,789 pairs), pattern
    only: 'auto' takes 'pairs' (the dense planes would be 13.9 GB, A is
    1.3% full), and K1's schedule has 3,969 one-block tiles staging
    2.86 GB a multiply."""
    c = CONFIG
    pat = fd.patterns(c["rsb"], c["rtb"], c["block_edge"], c["dimension"],
                      c["nfd"])
    p = problems.Problem.from_columns(pat["nrows"], pat["ncols"],
                                      pat["a_cols"], pat["x_cols"],
                                      pat["b_cols"], 64, 64)
    plan = tt.create_plan(*_bsrs(p), device="cpu")
    shapes = c["shapes"]
    assert (plan.nrows, plan.nnzb_a, plan.nnzb_x, int(plan.pairs.shape[0])
            ) == (shapes["block_rows"], shapes["a_blocks"],
                  shapes["x_blocks"], shapes["pairs"])
    # the rule alone: a Solver's __init__ would also make its 260 MB shadow
    # vector
    s = tt.Solver.__new__(tt.Solver)
    s.plan, s.precision, s.lm, s.ln, s._pack = plan, "z", 64, 64, None
    assert s._choose_engine("auto", 0) == "pairs"
    sched = pp.tile_schedule(plan, 64, 64)
    assert (sched.warps_m, sched.warps_n) == (2, 2)
    assert (sched.ntiles, sched.nsteps) == (3969, 21789)
    assert sched.staged_bytes == 2_855_927_808

"""The host side of the port's sharded layer, in this process: the
partition tables against the JAX package's, the shard's pair table for K1
and its tile schedule with a separate X side, the row-tile multiply over a
gathered panel, and the rule that ``tfqmrgpu_tpu_torch/parallel/`` imports
neither JAX nor the JAX package."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from conftest import make_random_problem
from test_torch_solver import _port
from tfqmrgpu_tpu.parallel import partition as jpart
from tfqmrgpu_tpu.plan import create_plan as jcreate_plan
from tfqmrgpu_tpu_torch import create_plan
from tfqmrgpu_tpu_torch.ops import pairpanel as pp
from tfqmrgpu_tpu_torch.ops import pallas_spmm as rt
from tfqmrgpu_tpu_torch.ops.blocksparse import spmm_pairs
from tfqmrgpu_tpu_torch.ops.panel import PanelLayout
from tfqmrgpu_tpu_torch.parallel import partition as tpart
from tfqmrgpu_tpu_torch.parallel.sharded import halo_index, shard_pair_table

torch.set_num_threads(2)

PARALLEL = pathlib.Path(tpart.__file__).parent


def _plans(rng, mb=24, lm=4, ln=8, ncols=6, x_fill=0.6):
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                                  x_fill=x_fill)
    jplan = jcreate_plan(a, x, b)
    jplan.lm, jplan.ln = lm, ln
    plan = create_plan(*_port(a, x, b), device="cpu")
    plan.lm, plan.ln = lm, ln
    return jplan, plan, (a, x, b)


@pytest.mark.parametrize("pr,pc,mb,ncols", [
    (2, 1, 24, 6), (4, 1, 24, 6), (2, 2, 24, 6), (4, 2, 24, 6),
    (4, 2, 13, 3),             # uneven: padded rows, pairs and columns
], ids=["2x1", "4x1", "2x2", "4x2", "uneven_4x2"])
def test_partition_tables_identical_to_jax(rng, pr, pc, mb, ncols):
    jplan, plan, _ = _plans(rng, mb=mb, ncols=ncols)
    want = jpart.partition_plan(jplan, pr, pc)
    got = tpart.partition_plan(plan, pr, pc)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name


def test_shard_arrays_identical_to_jax(rng):
    jplan, plan, (a, x, b) = _plans(rng)
    part = tpart.partition_plan(plan, 2, 2)
    jp = jpart.partition_plan(jplan, 2, 2)
    xs = np.random.default_rng(1).standard_normal((plan.nnzb_x, 4, 8))
    for name, arr in (("blocks", xs), ("b", b.data.real),
                      ("a", a.data.real)):
        got = getattr(tpart, f"shard_{name}_array")(part, arr)
        assert np.array_equal(got, getattr(jpart, f"shard_{name}_array")(
            jp, arr))
    back = tpart.unshard_blocks_array(
        part, tpart.shard_blocks_array(part, xs), plan.nnzb_x)
    assert np.array_equal(back, xs)


def _gathered(part, col, xs):
    """X of the row shards of column chunk ``col`` in the halo layout:
    [pr, 2, nmax] re/im slots, flat, as ``sharded.Halo`` gathers them."""
    nmax = part.nmax
    g = np.zeros((part.pr, 2, nmax) + xs.shape[1:])
    for s in range(part.pr):
        m = part.blocks[s, col] >= 0
        g[s, 0, m] = xs[part.blocks[s, col][m]].real
        g[s, 1, m] = xs[part.blocks[s, col][m]].imag
    flat = torch.from_numpy(g.reshape((-1,) + xs.shape[1:]))
    span = (2 * part.pr - 1) * nmax
    return flat[:span], flat[nmax:nmax + span]


@pytest.mark.parametrize("pr,pc", [(2, 1), (2, 2), (4, 2)])
def test_shard_pair_table_gives_the_shards_blocks(rng, pr, pc):
    """K1's plain version over each shard's table against the gathered X
    gives that shard's Y blocks of the whole product, and the tile
    schedule of the table runs exactly its pairs."""
    _, plan, (a, _, _) = _plans(rng)
    part = tpart.partition_plan(plan, pr, pc)
    r2 = np.random.default_rng(2)
    xs = r2.standard_normal((plan.nnzb_x, 4, 8)) \
        + 1j * r2.standard_normal((plan.nnzb_x, 4, 8))
    ap = tuple(torch.from_numpy(np.ascontiguousarray(v))
               for v in (a.data.real, a.data.imag))
    whole = spmm_pairs(ap, tuple(torch.from_numpy(np.ascontiguousarray(v))
                                 for v in (xs.real, xs.imag)),
                       plan.pairs[:, 0], plan.pairs[:, 1], plan.pair_y(),
                       plan.nnzb_x)
    for r in range(pr):
        for c in range(pc):
            table, a_ids = shard_pair_table(plan, part, r, c, "cpu")
            k1 = pp.PairPlanMultiply(table, ap[0][a_ids].contiguous(),
                                     ap[1][a_ids].contiguous(), 8)
            y = k1(_gathered(part, c, xs))
            mine = part.blocks[r, c, :table.nnzb_y]
            assert y[0].shape[0] == table.nnzb_y
            for got, want in zip(y, whole):
                assert torch.allclose(got, want[mine], rtol=0, atol=1e-12)
            ia, ix, iy = k1.schedule.products()
            want_pairs = sorted(zip(table.pair_y().tolist(),
                                    table.pairs[:, 0].tolist(),
                                    table.pairs[:, 1].tolist()))
            assert sorted(zip(iy.tolist(), ia.tolist(),
                              ix.tolist())) == want_pairs


@pytest.mark.parametrize("case", [(4, 4), (8, 8), (16, 32)], ids=str)
def test_schedule_with_equal_sides_is_unchanged(rng, case):
    """Passing a plan's own patterns as the X side changes no table."""
    lm, ln = case
    _, plan, _ = _plans(rng, mb=14, lm=lm, ln=ln, ncols=5)
    args = (plan.rowptr_x, plan.colindx.numpy(), plan.starts.numpy(),
            plan.pairs.numpy(), lm, ln)
    row = np.repeat(np.arange(plan.nrows), np.diff(plan.rowptr_x))
    for grid in pp.warp_grids(lm, ln):
        want = pp.build_tile_schedule(*args, grid)
        got = pp.build_tile_schedule(*args, grid, x_rows=row,
                                     x_cols=plan.colindx.numpy())
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            assert (np.array_equal(g, w) if isinstance(w, np.ndarray)
                    else g == w), f.name
    rule = pp.tile_schedule(plan, lm, ln)
    table = pp.tile_schedule(pp.PairTable.from_plan(plan), lm, ln)
    assert np.array_equal(rule.step_x, table.step_x)
    assert np.array_equal(rule.tile_y, table.tile_y)


def test_rowtile_multiply_over_a_gathered_panel(rng):
    """K3's plain version with ``x_rows``: a slab's tiles over the halo
    layout of the gathered panel give the slab's rows of the whole
    masked product."""
    lm = ln = 4
    _, plan, (a, _, _) = _plans(rng, mb=16, lm=lm, ln=ln, ncols=3,
                                x_fill=1.0)
    lay = PanelLayout.from_plan(plan)
    pr, mbl = 2, 8
    r2 = np.random.default_rng(3)
    panel = r2.standard_normal((2, lay.nr, lay.ncc, ln)).astype(np.float32)
    pack = rt.pack_row_tiles(plan.rowptr_a, plan.colind_a, lay.mb, lm, 2)
    whole = rt.RowTileMultiply(
        pack, *(torch.from_numpy(rt.build_a_panels(
            pack, v.astype(np.float32))) for v in (a.data.real,
                                                   a.data.imag)),
        lay.mask, ln)(tuple(torch.from_numpy(p) for p in panel))
    halo = np.zeros((pr, 2, mbl * lm, lay.ncc, ln), np.float32)
    for s in range(pr):
        halo[s] = panel[:, s * mbl * lm:(s + 1) * mbl * lm]
    flat = torch.from_numpy(halo.reshape(-1, lay.ncc, ln))
    span = (2 * pr - 1) * mbl * lm
    x = (flat[:span], flat[mbl * lm:mbl * lm + span])
    for s in range(pr):
        rp = plan.rowptr_a[s * mbl:(s + 1) * mbl + 1]
        p = rt.pack_row_tiles(rp - rp[0], plan.colind_a[rp[0]:rp[-1]], mbl,
                              lm, 2)
        p = p._replace(xcols=halo_index(p.xcols // mbl, p.xcols % mbl,
                                        mbl).astype(np.int32))
        k3 = rt.RowTileMultiply(
            p, *(torch.from_numpy(rt.build_a_panels(
                p, v[rp[0]:rp[-1]].astype(np.float32)))
                 for v in (a.data.real, a.data.imag)),
            lay.mask[s * mbl:(s + 1) * mbl], ln, x_rows=(2 * pr - 1) * mbl)
        y = k3(x)
        rows = slice(s * mbl * lm, (s + 1) * mbl * lm)
        for got, want in zip(y, whole):
            assert got.shape == (mbl * lm, lay.ncc, ln)
            assert torch.allclose(got, want[rows], rtol=0, atol=1e-4)


def test_parallel_imports_neither_jax_nor_the_jax_package():
    files = sorted(PARALLEL.glob("*.py"))
    assert {f.name for f in files} >= {
        "__init__.py", "partition.py", "sharded.py", "sharded_rowtile.py",
        "sharded_panel.py", "mixed.py", "multihost.py", "scaling.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [n.name for n in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "tfqmrgpu_tpu"), (f.name, n)

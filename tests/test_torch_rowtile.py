"""The port's row-tile engine against the JAX package's on the CPU: packing
tables identical, the multiply against the TPU kernel K3 run in interpret
mode at precision 'highest' (1e-5 relative: FP32 sums in another order),
and the 'pallas' solve with the same iteration counts and statuses and X to
1e-4 relative (FP32 vector passes in another order).  The Hopper kernel
itself is tested on the card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_problem
from test_torch_panel import _plans, _port, assert_same_solve, jax_and_port
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.ops import pallas_spmm as jrt
from tfqmrgpu_tpu.ops.panel import PanelLayout as JLayout
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import pallas_spmm as trt
from tfqmrgpu_tpu_torch.ops import paneltiles
from tfqmrgpu_tpu_torch.ops.panel import PanelLayout

torch.set_num_threads(2)

PACK_TABLES = ("xcols", "tile_of", "rslot_of", "kslot_of")


@pytest.mark.parametrize("seed,mb,lm", [(0, 13, 4), (1, 16, 8), (2, 9, 16)])
def test_pack_row_tiles_identical(seed, mb, lm):
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=lm, ncols=2)
    jp, tp = _plans(a, x, b, lm, lm)
    for r_tile in range(1, mb + 1):
        want = jrt.pack_row_tiles(jp.rowptr_a, jp.colind_a, mb, lm, r_tile)
        got = trt.pack_row_tiles(tp.rowptr_a, tp.colind_a, mb, lm, r_tile)
        for k in ("ntiles", "r_tile", "ku", "lm", "inflation"):
            assert getattr(got, k) == getattr(want, k), (r_tile, k)
        for k in PACK_TABLES:
            g, w = getattr(got, k), getattr(want, k)
            assert g.dtype == w.dtype and np.array_equal(g, w), (r_tile, k)
    pack = trt.choose_row_tile(tp, lm)
    are = a.data.real.astype(np.float32)
    host = trt.build_a_panels(pack, are)
    assert np.array_equal(host, jrt.build_a_panels(pack, are))
    dev = trt.build_a_panels_device(pack, torch.from_numpy(are))
    assert np.array_equal(dev.numpy(), host)


@pytest.mark.parametrize("seed,lm", [(3, 4), (4, 8), (5, 16)])
def test_choose_row_tile_matches_jax_solver(seed, lm):
    a, x, b = make_random_problem(np.random.default_rng(seed), mb=16, lm=lm,
                                  ln=lm, ncols=2, dtype=np.complex64)
    js = jsolver.Solver(a, x, b, precision="c", engine="pallas")
    _, tp = _plans(a, x, b, lm, lm)
    got = trt.choose_row_tile(tp, lm)
    assert (got.r_tile, got.ku, got.ntiles) == (
        js._pack.r_tile, js._pack.ku, js._pack.ntiles)
    assert np.array_equal(got.xcols, js._pack.xcols)


def _multiply_pair(seed, mb, lm, ln, ncols, r_tile):
    """The port's RowTileMultiply (plain, on the CPU) and the JAX package's
    bsr_panel_multiply (interpret mode, 'highest') on the same inputs."""
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols)
    jp, tp = _plans(a, x, b, lm, ln)
    lay = PanelLayout.from_plan(tp)
    pack = trt.pack_row_tiles(tp.rowptr_a, tp.colind_a, mb, lm, r_tile)
    f32 = np.float32
    are, aim = a.data.real.astype(f32), a.data.imag.astype(f32)
    xv = rng.standard_normal((2, tp.nnzb_x, lm, ln)).astype(f32)
    xp = [lay.pack_x(v) for v in xv]
    mask4 = lay.mask[:, None, :, None].astype(f32)
    jm = jrt.bsr_panel_multiply(
        jnp.asarray(jrt.build_a_panels(pack, are)),
        jnp.asarray(jrt.build_a_panels(pack, aim)), jnp.asarray(pack.xcols),
        jnp.asarray(mask4), mb, lm, lay.ncc, ln, interpret=True,
        precision="highest", t_step=1)
    want = [np.asarray(v) for v in jm(tuple(jnp.asarray(p) for p in xp))]
    tm = trt.RowTileMultiply(
        pack, torch.from_numpy(trt.build_a_panels(pack, are)),
        torch.from_numpy(trt.build_a_panels(pack, aim)), lay.mask, ln)
    return tm, [torch.from_numpy(p) for p in xp], want, pack


@pytest.mark.parametrize("seed,mb,lm,ln,ncols,r_tile", [
    (6, 12, 4, 8, 3, 1), (7, 13, 4, 4, 2, 4), (8, 10, 8, 8, 2, 3),
    (9, 9, 8, 10, 3, 2),
])
def test_rowtile_multiply_matches_tpu_kernel_interpret(seed, mb, lm, ln,
                                                       ncols, r_tile):
    tm, xp, want, _ = _multiply_pair(seed, mb, lm, ln, ncols, r_tile)
    before = trt.RowTileMultiply.launches
    got = tm(tuple(xp))
    assert trt.RowTileMultiply.launches == before   # the CPU never launches
    scale = max(np.max(np.abs(w)) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * scale


@pytest.mark.parametrize("seed,mb,lm,ln,ncols,r_tile", [
    (20, 12, 4, 8, 3, 1), (21, 13, 4, 4, 2, 4), (22, 9, 8, 16, 5, 2),
])
def test_rowtile_unit_tables_follow_the_pack(seed, mb, lm, ln, ncols, r_tile):
    """The tables K3 runs on the card, built by the wrapper on the CPU too:
    every tile's real union blocks, in the pack's order, for the CTA shape
    of its column count; and the plain walker over them against the TPU
    kernel in interpret mode."""
    tm, xp, want, pack = _multiply_pair(seed, mb, lm, ln, ncols, r_tile)
    u = tm.units
    shape = paneltiles.cta_shape(tm.c)
    assert (u.bm, u.union) == (shape[0], shape == paneltiles.WIDE)
    assert u.nt == max(shape[0] // tm.rlm, 1)
    for t in range(pack.ntiles):
        used = np.unique(pack.kslot_of[pack.tile_of == t])
        assert np.array_equal(used, np.arange(tm.kcount[t]))
        g, n = divmod(t, u.nt)
        steps = np.flatnonzero(u.ukidx[g, :, n] >= 0)
        assert np.array_equal(u.ukidx[g, steps, n], used)
        assert np.array_equal(u.uslot[g, steps, n], pack.xcols[t, used])
    items, cta_start = paneltiles.work_list(u, tm.c, shape[1], 132)
    assert cta_start[-1] == len(items)
    y_re, y_im, writes = paneltiles.walk(
        u, items, paneltiles.depth_major(tm.a_fused),
        xp[0].reshape(tm.nr, tm.c), xp[1].reshape(tm.nr, tm.c), lm, tm.nr,
        shape[1])
    assert np.all(writes == 1)
    keep = np.repeat(np.repeat(tm.mask.numpy(), lm, axis=0), ln, axis=1)
    scale = max(np.max(np.abs(w)) for w in want)
    for y, w in zip((y_re, y_im), want):
        got = (y.numpy() * keep).reshape(w.shape)
        assert np.max(np.abs(got - w)) <= 1e-4 * scale


def test_rowtile_wrapper_rejects_bad_inputs():
    tm, xp, _, pack = _multiply_pair(10, 8, 4, 4, 2, 2)
    with pytest.raises(ValueError):                 # float64 x
        tm((xp[0].double(), xp[1].double()))
    with pytest.raises(ValueError):                 # wrong shape
        tm((xp[0][:-1], xp[1][:-1]))
    with pytest.raises(ValueError):                 # not contiguous
        tm((xp[0].transpose(1, 2).contiguous().transpose(1, 2), xp[1]))
    mask = tm.mask.numpy().astype(bool)
    a64 = torch.zeros((pack.ntiles, tm.rlm, pack.ku * pack.lm),
                      dtype=torch.float64)
    with pytest.raises(ValueError):                 # A panels of the wrong shape
        trt.RowTileMultiply(pack, a64[:-1].float(), a64[:-1].float(), mask,
                            tm.ln)
    with pytest.raises(tt.TfqmrgpuError) as e:      # the engine is FP32-only
        trt.RowTileMultiply(pack, a64, a64, mask, tm.ln)
    assert e.value.code == Status.PRECISION_MISSMATCH


@pytest.mark.parametrize("seed,mb,lm,ln,ncols", [
    (11, 12, 4, 8, 3), (12, 10, 8, 8, 2),
])
def test_rowtile_solve_matches_jax(monkeypatch, seed, mb, lm, ln, ncols):
    a, x, b = make_random_problem(np.random.default_rng(seed), mb=mb, lm=lm,
                                  ln=ln, ncols=ncols, dtype=np.complex64)
    res = jax_and_port(monkeypatch, a, x, b, engine="pallas", precision="c",
                       tol=1e-5, maxit=300)
    assert res[3].return_status == Status.SUCCESS
    assert_same_solve(*res, rtol=1e-4)


def test_rowtile_trivial_rhs_and_initial_guess_match_jax(monkeypatch):
    a, x, b = make_random_problem(np.random.default_rng(13), mb=10, lm=4,
                                  ln=8, ncols=2, x_fill=1.0,
                                  dtype=np.complex64)
    res = jax_and_port(monkeypatch, a, x, b, engine="pallas", precision="c",
                       tol=1e-5, maxit=300, rhs_trivial=True)
    assert res[3].return_status == Status.SUCCESS
    assert_same_solve(*res, rtol=1e-4)
    rng = np.random.default_rng(14)
    x0 = (0.01 * (rng.standard_normal((x.nnzb, 4, 8))
                  + 1j * rng.standard_normal((x.nnzb, 4, 8)))).astype(
                      np.complex64)
    res = jax_and_port(monkeypatch, a, x, b, engine="pallas", precision="c",
                       tol=1e-5, maxit=300, x0=x0)
    assert res[3].return_status == Status.SUCCESS
    assert_same_solve(*res, rtol=1e-4)


def test_panel_layout_of_rowtile_solver_is_jax_layout():
    a, x, b = make_random_problem(np.random.default_rng(15), mb=9, lm=4,
                                  ln=4, ncols=2, dtype=np.complex64)
    js = jsolver.Solver(a, x, b, precision="c", engine="pallas")
    ts = tt.Solver(*_port(a, x, b), precision="c", engine="pallas",
                   device="cpu")
    jl = JLayout.from_plan(js.plan)
    assert np.array_equal(ts._layout.mask, jl.mask)
    assert ts._v3[0].shape == (jl.nr, jl.ncc, jl.ln)

"""The hand-written kernels (pair-plan K1, packed pair-plan K2, row-tile
K3, stream probe K4, the oz kernel of K1's Ozaki modes) and their build,
K1 driven from C through the port's
C library, K1, K2 and K3 under the sharded engines at one rank, and under
the autotuner's timing and the roofline at the golden class.

Imports neither JAX nor tests/conftest.py, so that the card-only tests run
on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a card those tests skip; the build and wrapper tests run anywhere.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (OZ_BOUND, OZ_CASES, OZ_RANDOM, OZ_SHAPES,
                        SPLIT_GATE, SPLIT_SHAPES, STAGED_SHAPES, _as_tuple,
                        _misaligned, _rowtile_multiply, c_onecall, check_oz,
                        check_oz_slices, check_staged, cos_sin,
                        dominant_fill, f64_product, fused_x,
                        golden_c_problem, golden_class_patterns,
                        golden_z_problem, oz_bound_case, oz_multiply,
                        oz_random_case, oz_sizes, pack_plan, packed_multiply,
                        planes, random_problem, split_case, wide_blocks)
from tfqmrgpu_tpu_torch import (ALLOWED_BLOCK_SIZES, Solver, _build,
                                autotune, create_plan, dma_probe, native,
                                profiling)
from tfqmrgpu_tpu_torch.ops import pairpanel as pp
from tfqmrgpu_tpu_torch.ops import paneltiles as pt
from tfqmrgpu_tpu_torch.ops.pairpanel import PairPanelMultiply, PairPlanMultiply
from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

torch.set_num_threads(2)

GATES = {"z": (torch.float64, 1e-12), "c": (torch.float32, 1e-4)}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _maxdev(got, want):
    dev = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return dev / max(float(w.abs().max()) for w in want)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    path = _build.library_path()
    assert path.parent.parent == tmp_path / "kernels"
    assert path == _build.library_path()        # keyed by the sources only


def test_cpu_multiply_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    rng = np.random.default_rng(0)
    plan = create_plan(*random_problem(rng, mb=10, lm=4, ln=8, ncols=3),
                       device="cpu")
    av = rng.standard_normal((plan.nnzb_a, 4, 4, 2)) @ [1, 1j]
    xv = rng.standard_normal((plan.nnzb_x, 4, 8, 2)) @ [1, 1j]
    mult = PairPlanMultiply(plan, *planes(av, torch.float64, "cpu"), 8)
    before = PairPlanMultiply.launches
    y = mult(planes(xv, torch.float64, "cpu"))
    assert PairPlanMultiply.launches == before
    assert torch.equal(y[0], mult.plain(planes(xv, torch.float64, "cpu"))[0])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["z", "c"])
def test_kernel_matches_plain_on_card(precision):
    """K1 at all 15 block sizes and the golden class; in 'z' under the
    rule's tile schedule and every other warp grid of the size."""
    _needs_card()
    dtype, gate = GATES[precision]
    rng = np.random.default_rng(1)
    cases = [(create_plan(*random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3),
                          device="cuda"), lm, ln)
             for lm, ln in ALLOWED_BLOCK_SIZES]
    cases.append((create_plan(*golden_class_patterns(), device="cuda"), 32, 32))
    for plan, lm, ln in cases:
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        grids = [None] + (pp.warp_grids(lm, ln) if precision == "z" else [])
        for grid in grids:
            mult = PairPlanMultiply(plan, *planes(av, dtype, "cuda"), ln,
                                    grid=grid)
            x = planes(xv, dtype, "cuda")
            before = PairPlanMultiply.launches
            got = mult(x)
            torch.cuda.synchronize()
            assert PairPlanMultiply.launches == before + 1
            assert _maxdev(got, mult.plain(x)) <= gate, (lm, ln, grid)
            again = mult(x)                        # no atomics: same bits
            assert torch.equal(again[0], got[0]) and torch.equal(again[1],
                                                                 got[1])


@pytest.mark.cuda
def test_solve_on_card_matches_cpu():
    _needs_card()
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    prob = generate_fd_problem(rtb=4.75)
    a, b = prob.a_with_data(), prob.b_with_data()
    infos, xs = [], []
    for device in ("cpu", "cuda", "cuda"):
        s = Solver(a, prob.x, b, precision="z", engine="pairs",
                   device=device)
        infos.append(s.solve(tolerance=1e-9, max_iterations=500))
        xs.append(s.get_matrix("X"))
    assert [i.iterations_needed for i in infos] == [infos[0].iterations_needed] * 3
    assert all(i.return_status == 0 for i in infos)
    assert np.array_equal(xs[1], xs[2])            # repeatable on the card
    assert np.max(np.abs(xs[1] - xs[0])) <= 1e-10 * np.max(np.abs(xs[0]))


def _packed(rng, lm, ln, group, r_tile, device, ncols=4):
    """A PairPanelMultiply (K2) on a random plan and its fused X panel."""
    plan = create_plan(*random_problem(rng, mb=12, lm=lm, ln=ln, ncols=ncols),
                       device=device)
    av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
    xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
    mult, x, _ = packed_multiply(plan, lm, ln, av, xv, device, group, r_tile)
    return mult, x


def test_cpu_packed_multiply_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    mult, x = _packed(np.random.default_rng(4), 4, 8, 2, 1, "cpu")
    before = PairPanelMultiply.launches
    assert torch.equal(mult(x), mult.plain(x))
    assert PairPanelMultiply.launches == before


@pytest.mark.cuda
def test_packed_kernel_matches_plain_on_card():
    _needs_card()
    rng = np.random.default_rng(5)
    cases = [(lm, ln, group, r_tile)
             for lm, ln in ((4, 4), (4, 5), (8, 9), (8, 10), (16, 64), (32, 32))
             for group in (1, 2) for r_tile in (1, 2, 4)]
    cases += [(32, 64, 8, 1), (4, 32, 16, 1)]            # 512-lane planes
    for lm, ln, group, r_tile in cases:
        mult, x = _packed(rng, lm, ln, group, r_tile, "cuda",
                          ncols=max(4, group))
        before = PairPanelMultiply.launches
        got = mult(x)
        torch.cuda.synchronize()
        assert PairPanelMultiply.launches == before + 1
        assert _maxdev((got,), (mult.plain(x),)) <= 1e-4, (lm, ln, group,
                                                            r_tile)
        assert torch.equal(mult(x), got)           # no atomics: same bits


def _merged(rng, lm, ln, f_row, group, device, ncols=4):
    """K2 over a superblock-merged plan (``ops/superblock.py``, after a
    column grouping of ``group``) of a random plan, and its fused X panel
    with the dead merged slots zero."""
    from tfqmrgpu_tpu_torch.ops import superblock as sb

    plan = create_plan(*random_problem(rng, mb=16, lm=lm, ln=ln, ncols=ncols),
                       device=device)
    pairs = plan.pairs.cpu().numpy().astype(np.int64)
    pair_y = plan.pair_y().cpu().numpy()
    row_of = np.repeat(np.arange(plan.nrows), np.diff(plan.rowptr_x))
    cols = plan.colindx.cpu().numpy().astype(np.int64)
    xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)).astype(np.float32)
    xre, xim = np.ascontiguousarray(xv[..., 0]), np.ascontiguousarray(
        xv[..., 1])
    if group > 1:
        gp = pp.pack_grouped(pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x,
                             ln, group, row_of=row_of, col_of=cols)
        rm = sb.pack_rowmerge(gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2,
                              lm, gp.ln2, f_row, row_of=gp.row_of2,
                              col_of=gp.col_of2, verify=False)
        xre, xim = pp.grouped_blocks(gp, xre), pp.grouped_blocks(gp, xim)
    else:
        rm = sb.pack_rowmerge(pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x,
                              lm, ln, f_row, row_of=row_of, col_of=cols)
    pplan = pp.pack_pair_plan(rm.pair_a2, rm.pair_x2, rm.pair_y2, rm.n_cells,
                              rm.n_cells, rm.lm2, rm.ln, r_tile=1,
                              row_of=rm.row_of2, col_of=rm.col_of2)
    a_re, a_im = (sb.merge_a_blocks(rm, v) for v in planes(
        rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j],
        torch.float32, device))
    mult = pp.PairPanelMultiply(pplan, pp.build_a_panels_device(pplan, a_re,
                                                                a_im))
    x = torch.from_numpy(pp.permute_x(pplan, sb.merge_xy_blocks(rm, xre),
                                      sb.merge_xy_blocks(rm, xim)))
    return mult, x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("lm,ln", [(8, 8), (4, 8)])
@pytest.mark.parametrize("f_row,group", [(2, 1), (4, 1), (2, 2), (4, 4)])
def test_merged_packed_kernel_matches_plain_on_card(lm, ln, f_row, group):
    """K2 on a superblock-merged plan (LM' = f*LM, lanes narrower than LM'
    without groups) against its plain version, the same bits on a repeat."""
    _needs_card()
    mult, x = _merged(np.random.default_rng(8 + f_row + group), lm, ln,
                      f_row, group, "cuda")
    assert mult.lm == f_row * lm
    before = PairPanelMultiply.launches
    got = mult(x)
    torch.cuda.synchronize()
    assert PairPanelMultiply.launches == before + 1
    assert _maxdev((got,), (mult.plain(x),)) <= 1e-4
    assert torch.equal(mult(x), got)


@pytest.mark.cuda
def test_merged_solve_launches_k2_at_merged_lm_on_card(monkeypatch):
    """A 'c' 'pairs' solve with TFQ_SOLVER_SUPER=4 at LM 8: every multiply
    through K2 at LM 32, converged, X as on the CPU."""
    _needs_card()
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "4")
    rng = np.random.default_rng(9)
    a, x, b = random_problem(rng, mb=24, lm=8, ln=8, ncols=4)
    ad = rng.standard_normal((a.nnzb, 8, 8, 2)) @ [1, 1j]
    ad[a.colind == np.repeat(np.arange(a.nrows), np.diff(a.rowptr))] += (
        64.0 * np.eye(8))                       # diagonally dominant
    a = a.with_data(ad.astype(np.complex64))
    b = b.with_data((rng.standard_normal((b.nnzb, 8, 8, 2)) @ [1, 1j])
                    .astype(np.complex64))
    xs = []
    for device in ("cpu", "cuda"):
        s = Solver(a, x, b, precision="c", engine="pairs", device=device)
        assert s._sup is not None and s._multiply.lm == 32
        before = PairPanelMultiply.launches
        info = s.solve(tolerance=1e-5, max_iterations=300)
        assert info.return_status == 0
        launches = PairPanelMultiply.launches - before
        assert launches == (0 if device == "cpu" else
                            2 * info.iterations_needed + info.n_probes)
        xs.append(s.get_matrix("X"))
    assert np.max(np.abs(xs[1] - xs[0])) <= 1e-4 * np.max(np.abs(xs[0]))


def _staged_problem(seed, lm, ln, ncols, integer):
    rng = np.random.default_rng(seed)
    plan = create_plan(*random_problem(rng, mb=16, lm=lm, ln=ln, ncols=ncols),
                       device="cuda")
    if integer:     # every sum exact in float32, whatever its order
        av = rng.integers(-3, 4, (plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.integers(-3, 4, (plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
    else:
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
    return plan, av, xv


@pytest.mark.cuda
@pytest.mark.parametrize("lm,ln,group,r_tile", STAGED_SHAPES)
def test_packed_kernel_staged_shapes_on_card(lm, ln, group, r_tile):
    """K2 at the shapes of the staged design: against plain, the same bits
    on a repeat, from a misaligned x and from other work lists; and on
    integer data bit for bit what the plain walker gives."""
    _needs_card()
    plan, av, xv = _staged_problem(6, lm, ln, group, False)
    check_staged(lambda slots: packed_multiply(
        plan, lm, ln, av, xv, "cuda", group, r_tile, slots)[:2],
        f"K2 ({lm},{ln}) G {group} r_tile {r_tile}")
    plan, av, xv = _staged_problem(7, lm, ln, group, True)
    mult, x, pplan = packed_multiply(plan, lm, ln, av, xv, "cuda", group,
                                     r_tile)
    got = mult(x).cpu()
    c = pplan.ln
    items, _ = pt.work_list(mult.units, c, mult.launch_tables.bn, 7)
    y_re, y_im, writes = pt.walk(
        mult.units, items, mult.a_dm.cpu(), x[:, :c].contiguous().cpu(),
        x[:, c:].contiguous().cpu(), lm, mult.n_rows, mult.launch_tables.bn)
    assert np.all(writes == 1)
    assert torch.equal(got, torch.cat([y_re, y_im], dim=1))
    assert torch.equal(got, mult.plain(x).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("lm,ln,ncols,r_tile", STAGED_SHAPES)
def test_rowtile_kernel_staged_shapes_on_card(lm, ln, ncols, r_tile):
    """K3 at the shapes of the staged design, as K2 above."""
    _needs_card()
    plan, av, xv = _staged_problem(8, lm, ln, ncols, False)
    check_staged(lambda slots: _rowtile_multiply(
        plan, lm, ln, av, xv, "cuda", r_tile, slots)[:2],
        f"K3 ({lm},{ln}) x {ncols} columns, r_tile {r_tile}")
    plan, av, xv = _staged_problem(9, lm, ln, ncols, True)
    mult, x, _ = _rowtile_multiply(plan, lm, ln, av, xv, "cuda", r_tile)
    got = [v.cpu() for v in mult(x)]
    want = [v.cpu() for v in mult.plain(x)]
    items, _ = pt.work_list(mult.units, mult.c, mult.launch_tables.bn, 7)
    y_re, y_im, writes = pt.walk(
        mult.units, items, mult.a_dm.cpu(), x[0].reshape(mult.nr, -1).cpu(),
        x[1].reshape(mult.nr, -1).cpu(), lm, mult.nr, mult.launch_tables.bn)
    keep = np.repeat(np.repeat(mult.mask.cpu().numpy(), lm, axis=0), ln,
                     axis=1).astype(np.float32)
    assert np.all(writes == 1)
    for g, w, y in zip(got, want, (y_re, y_im)):
        assert torch.equal(g, w)
        assert torch.equal(g.reshape(mult.nr, -1), y * torch.from_numpy(keep))


def _rowtile(rng, lm, ln, r_tile, device):
    """A RowTileMultiply on a random plan and an X panel, on ``device``."""
    plan = create_plan(*random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3),
                       device=device)
    av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
    xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
    mult, x, _ = _rowtile_multiply(plan, lm, ln, av, xv, device, r_tile)
    return mult, x


def test_cpu_rowtile_and_probe_never_build(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    mult, x = _rowtile(np.random.default_rng(2), 4, 8, 2, "cpu")
    before = RowTileMultiply.launches
    assert torch.equal(mult(x)[0], mult.plain(x)[0])
    assert RowTileMultiply.launches == before
    xs = dma_probe.operands(2, 1 << 20, "cpu")
    before = dma_probe.StreamProbe.launches
    assert torch.equal(dma_probe.StreamProbe(32 << 10)(xs), dma_probe.plain(xs))
    assert dma_probe.StreamProbe.launches == before


@pytest.mark.cuda
def test_rowtile_kernel_matches_plain_on_card():
    _needs_card()
    rng = np.random.default_rng(3)
    for lm, ln in ALLOWED_BLOCK_SIZES:
        for r_tile in (1, 4):
            mult, x = _rowtile(rng, lm, ln, r_tile, "cuda")
            before = RowTileMultiply.launches
            got = mult(x)
            torch.cuda.synchronize()
            assert RowTileMultiply.launches == before + 1
            assert _maxdev(got, mult.plain(x)) <= 1e-4, (lm, ln, r_tile)
            again = mult(x)                        # no atomics: same bits
            assert torch.equal(again[0], got[0]) and torch.equal(again[1],
                                                                 got[1])


@pytest.mark.cuda
def test_stream_probe_matches_plain_on_card():
    _needs_card()
    x = dma_probe.operands(2, 64 << 20, "cuda")
    want = dma_probe.plain(x)
    for stage in dma_probe.STAGE_BYTES:
        before = dma_probe.StreamProbe.launches
        got = dma_probe.StreamProbe(stage)(x)
        torch.cuda.synchronize()
        assert dma_probe.StreamProbe.launches == before + 1
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), stage


@pytest.mark.cuda
def test_c_one_call_runs_k1_on_card(monkeypatch):
    """A small 'z' one-call solve through the port's C library
    (``tfqmrgpu_bsrsv_z`` by ctypes, in this interpreter): 'auto' takes the
    'pairs' engine and every multiply goes through K1."""
    _needs_card()
    infos = []
    solve = Solver.solve

    def recorded(self, *args, **kwargs):
        infos.append(solve(self, *args, **kwargs))
        return infos[-1]

    monkeypatch.setattr(Solver, "solve", recorded)
    rng = np.random.default_rng(4)
    # 2048 rows of 4 x 4 blocks: the dense planes exceed the 'auto' limit
    a, x, b = golden_class_patterns(mb=512, deg=4, ncols=4)
    a = a.with_data(dominant_fill(rng, a.nnzb, 4, 4))
    b = b.with_data(rng.standard_normal((b.nnzb, 4, 4, 2)) @ [1, 1j])
    lib = native.load()
    PairPlanMultiply.launches = 0
    st, xc, iters, resid, _ = c_onecall(lib, "z", a, x, b, 1e-10, 500)
    launches = PairPlanMultiply.launches
    assert st == 0 and 0 < iters and resid <= 1e-10
    (info,) = infos
    assert info.engine == "pairs" and info.iterations_needed == iters
    assert launches == 2 * iters + info.n_probes
    assert np.isfinite(xc).all()


@pytest.fixture
def nccl_mesh():
    """A world of one rank on NCCL (the card) and its 1 x 1 mesh; the
    process group is torn down after the test (``multihost.shutdown``)."""
    _needs_card()
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch.parallel import make_mesh, multihost

    started = not dist.is_initialized()
    multihost.initialize(device="cuda:0")
    try:
        yield make_mesh(1, 1, device="cuda:0")
    finally:
        if started:
            multihost.shutdown()


@pytest.mark.cuda
def test_sharded_blocklist_multiply_runs_k1_on_card(nccl_mesh):
    """The block-list sharded multiply (halo all_gather over NCCL, then K1
    over the shard's pair table) against its plain version and the plan's
    whole product, in 'z' and 'c'."""
    from tfqmrgpu_tpu_torch.ops.blocksparse import spmm_pairs
    from tfqmrgpu_tpu_torch.parallel import ShardedAction, partition_plan

    rng = np.random.default_rng(5)
    plan = create_plan(*random_problem(rng, mb=40, lm=8, ln=8, ncols=4),
                       device="cuda")
    plan.lm = plan.ln = 8
    part = partition_plan(plan, 1, 1)
    av = rng.standard_normal((plan.nnzb_a, 8, 8, 2)) @ [1, 1j]
    xv = rng.standard_normal((plan.nnzb_x, 8, 8, 2)) @ [1, 1j]
    for precision in ("z", "c"):
        dtype, gate = GATES[precision]
        npdt = np.float64 if precision == "z" else np.float32
        act = ShardedAction.from_plan(plan, part, nccl_mesh,
                                      av.real.astype(npdt),
                                      av.imag.astype(npdt))
        x = planes(xv, dtype, "cuda")
        before = PairPlanMultiply.launches
        gathers = nccl_mesh.calls["all_gather"]
        y = act(x)
        torch.cuda.synchronize()
        assert PairPlanMultiply.launches == before + 1
        assert nccl_mesh.calls["all_gather"] == gathers + 1
        assert _maxdev(y, act.k1.plain(act.halo(x))) <= gate
        whole = spmm_pairs(planes(av, dtype, "cuda"), x, plan.pairs[:, 0],
                           plan.pairs[:, 1], plan.pair_y(), plan.nnzb_x)
        assert _maxdev(y, whole) <= gate


@pytest.mark.cuda
def test_sharded_rowtile_multiply_runs_k3_on_card(nccl_mesh):
    """The row-tile sharded multiply (halo all_gather of the panel over
    NCCL, then K3 on the gathered panel) against its plain version."""
    from tfqmrgpu_tpu_torch.parallel import ShardedRowTileSolver

    rng = np.random.default_rng(6)
    a, x, b = golden_class_patterns(mb=60, deg=5, ncols=4)
    plan = create_plan(a, x, b, device="cuda")
    plan.lm = plan.ln = 16
    sp = ShardedRowTileSolver(plan, nccl_mesh)
    av = rng.standard_normal((plan.nnzb_a, 16, 16, 2)) @ [1, 1j]
    sp.set_matrix_a(av.real, av.imag)
    xp = planes(rng.standard_normal((sp.nrl, sp.ncc, 16, 2)) @ [1, 1j],
                torch.float32, "cuda")
    before = RowTileMultiply.launches
    y = sp.multiply(xp)
    torch.cuda.synchronize()
    assert RowTileMultiply.launches == before + 1
    assert _maxdev(y, sp._k3.plain(sp._halo(xp))) <= 1e-4


@pytest.mark.cuda
def test_packed_kernel_tile_list_on_card():
    """K2 over a part of a plan (a tile-id list with pad tiles, rebased X
    rows of its own, written at a row offset into one Y) against its plain
    version on the card: the parts of every shard of a 3-shard layout."""
    _needs_card()
    from tfqmrgpu_tpu_torch.parallel import ShardedPairsLayout
    from tfqmrgpu_tpu_torch.parallel.dryrun import banded_problem

    rng = np.random.default_rng(7)
    plan = create_plan(*banded_problem(61, 1, 8, 8), device="cuda")
    plan.lm = plan.ln = 8
    lay = ShardedPairsLayout(plan, 3)
    assert lay.n_loc and lay.p + lay.q and lay.ntiles_pad > lay.pp_plan.ntiles
    p0, rows = lay.pp_plan, lay.vrows_local
    av = planes(rng.standard_normal((plan.nnzb_a, 8, 8, 2)) @ [1, 1j],
                torch.float32, "cuda")
    xg = torch.from_numpy(rng.standard_normal(
        (lay.vec_rows_pad, 2 * lay.ln)).astype(np.float32)).cuda()
    whole = lay.pr * lay.blocks_local
    for s, t in enumerate(lay.shards):
        xs = xg[s * rows:(s + 1) * rows].contiguous()
        y = torch.full((rows, 2 * lay.ln), float("nan"), device="cuda")
        want = torch.full_like(y, float("nan"))
        for tiles, xx, base, span, row0 in (
                (t.local, xs, t.local_base, lay.blocks_local, lay.p * 8),
                (t.prefix, xg, 0, whole, 0),
                (t.suffix, xg, 0, whole, (lay.tiles_local - lay.q) * 8)):
            if not tiles.size:
                continue
            k2 = pp.PairPanelMultiply(
                p0, pp.build_a_panels_device(p0, *av, tiles=tiles),
                tiles=tiles, src_base=base, span=span)
            before = PairPanelMultiply.launches
            k2(xx, y, row0)
            torch.cuda.synchronize()
            assert PairPanelMultiply.launches == before + 1
            want[row0:row0 + k2.n_rows] = k2.plain(xx)
        assert not torch.isnan(y).any()
        assert _maxdev((y,), (want,)) <= 1e-4, s


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_pairs_multiply_runs_k2_on_card(nccl_mesh, overlap):
    """The sharded packed-pairs multiply at one rank on NCCL: every tile
    local, or every tile remote through the asynchronous all_gather; one
    K2 launch a multiply, against the plan's whole product."""
    from tfqmrgpu_tpu_torch.parallel import ShardedPairsSolver

    rng = np.random.default_rng(8)
    a, x, b = golden_class_patterns(mb=60, deg=5, ncols=4)
    plan = create_plan(a, x, b, device="cuda")
    plan.lm = plan.ln = 16
    sp = ShardedPairsSolver(plan, nccl_mesh, overlap=overlap)
    av = rng.standard_normal((plan.nnzb_a, 16, 16, 2)) @ [1, 1j]
    sp.set_matrix_a(av.real, av.imag)
    lay = sp.layout
    xv = rng.standard_normal((plan.nnzb_x, 16, 16, 2)) @ [1, 1j]
    xf = torch.from_numpy(lay.pack_vec(xv.real.astype(np.float32),
                                       xv.imag.astype(np.float32))[0]).cuda()
    before = PairPanelMultiply.launches
    gathers = nccl_mesh.calls["all_gather"]
    y = sp.multiply(xf)
    torch.cuda.synchronize()
    assert PairPanelMultiply.launches == before + 1
    assert nccl_mesh.calls["all_gather"] == gathers + (0 if overlap else 1)
    whole = pp.PairPanelMultiply(lay.pp_plan, pp.build_a_panels_device(
        lay.pp_plan, *planes(av, torch.float32, "cuda")))
    assert _maxdev((y,), (whole.plain(xf),)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("engine,precision", [("pairs", "z"), ("pairs", "c"),
                                              ("pallas", "c")])
def test_time_multiply_and_roofline_at_the_golden_class_on_card(
        monkeypatch, engine, precision):
    """``autotune.time_multiply`` launches the candidate's kernel (K1, K2,
    K3) once a multiply of its three chains; the solve's fractions of the
    per-iteration ceiling lie in (0, 1.05]."""
    _needs_card()
    monkeypatch.delenv("TFQ_HBM_GBPS", raising=False)
    counter = {("pairs", "z"): PairPlanMultiply, ("pairs", "c"):
               PairPanelMultiply, ("pallas", "c"): RowTileMultiply}[
                   (engine, precision)]
    make = golden_z_problem if precision == "z" else golden_c_problem
    s = Solver(*make(), precision=precision, engine=engine, device="cuda")
    before = counter.launches
    assert autotune.time_multiply(s, nrep=4) > 0.0
    assert counter.launches - before == 3 * 4
    info, best, roof = profiling.timed_solve(
        s, tolerance=1e-10 if precision == "z" else 1e-5,
        max_iterations=500)
    assert info.return_status == 0 and best > 0.0
    assert roof.device_kind == torch.cuda.get_device_name(0)
    for frac in (roof.fraction_of_light, roof.fraction_of_sheet_light):
        assert 0.0 < frac <= 1.05


# ------------------------------------------- the bf16 split modes of K2, K3

SPLIT_MODES = ("bf16", "bf16x3", "bf16x4", "bf16x6")


def test_cpu_split_multiplies_never_build(monkeypatch):
    """A split mode on a CPU tensor runs its plain version and never builds
    or counts the tensor-core kernel."""
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    rng = np.random.default_rng(20)
    plan = create_plan(*random_problem(rng, mb=10, lm=16, ln=16, ncols=3),
                       device="cpu")
    av = rng.standard_normal((plan.nnzb_a, 16, 16, 2)) @ [1, 1j]
    xv = rng.standard_normal((plan.nnzb_x, 16, 16, 2)) @ [1, 1j]
    for mode in SPLIT_MODES:
        before = (RowTileMultiply.split_launches,
                  PairPanelMultiply.split_launches)
        m3, x3, _ = _rowtile_multiply(plan, 16, 16, av, xv, "cpu", 2,
                                      precision=mode)
        assert torch.equal(m3(x3)[0], m3.plain(x3)[0])
        m2, x2, _ = packed_multiply(plan, 16, 16, av, xv, "cpu", 2,
                                    precision=mode)
        assert torch.equal(m2(x2), m2.plain(x2))
        assert (RowTileMultiply.split_launches,
                PairPanelMultiply.split_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SPLIT_MODES[1:])
def test_split_rowtile_kernel_matches_plain_on_card(mode):
    """K3's tensor-core kernel at all 15 block sizes (LM 4 and 8 padded to
    the m16n8k16 depth) against its plain version, the same bits on a
    repeat, one split launch a call."""
    _needs_card()
    rng = np.random.default_rng(21)
    for lm, ln in ALLOWED_BLOCK_SIZES:
        for r_tile in (1, 4):
            plan = create_plan(*random_problem(rng, mb=12, lm=lm, ln=ln,
                                               ncols=3), device="cuda")
            av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
            xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
            mult, x, _ = _rowtile_multiply(plan, lm, ln, av, xv, "cuda",
                                           r_tile, precision=mode)
            before = (RowTileMultiply.launches,
                      RowTileMultiply.split_launches)
            got = mult(x)
            torch.cuda.synchronize()
            assert (RowTileMultiply.launches,
                    RowTileMultiply.split_launches) == (before[0],
                                                        before[1] + 1)
            assert _maxdev(got, mult.plain(x)) <= SPLIT_GATE, (lm, ln,
                                                               r_tile)
            again = mult(x)
            assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.cuda
def test_rowtile_bf16_runs_the_fp32_kernel_on_card():
    _needs_card()
    plan = create_plan(*random_problem(np.random.default_rng(22), mb=12,
                                       lm=8, ln=8, ncols=3), device="cuda")
    rng = np.random.default_rng(23)
    av = rng.standard_normal((plan.nnzb_a, 8, 8, 2)) @ [1, 1j]
    xv = rng.standard_normal((plan.nnzb_x, 8, 8, 2)) @ [1, 1j]
    ys = []
    for mode in ("highest", "bf16"):
        m, xp, _ = _rowtile_multiply(plan, 8, 8, av, xv, "cuda", 2,
                                     precision=mode)
        before = (RowTileMultiply.launches, RowTileMultiply.split_launches)
        ys.append(m(xp))
        assert (RowTileMultiply.launches,
                RowTileMultiply.split_launches) == (before[0] + 1, before[1])
    assert all(torch.equal(p, q) for p, q in zip(*ys))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SPLIT_MODES)
def test_split_packed_kernel_matches_plain_on_card(mode):
    """K2's tensor-core kernel at the LM >= 16 sizes with G 1 and 2 and at
    a merged (8, 8) pack of LM' 16."""
    _needs_card()
    rng = np.random.default_rng(24)
    for lm, ln in ALLOWED_BLOCK_SIZES:
        if lm < 16:
            continue
        plan = create_plan(*random_problem(rng, mb=12, lm=lm, ln=ln,
                                           ncols=3), device="cuda")
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for group in (1, 2):
            mult, x, _ = packed_multiply(plan, lm, ln, av, xv, "cuda", group,
                                         precision=mode)
            before = PairPanelMultiply.split_launches
            got = mult(x)
            torch.cuda.synchronize()
            assert PairPanelMultiply.split_launches == before + 1
            assert _maxdev((got,), (mult.plain(x),)) <= SPLIT_GATE, (
                lm, ln, group)
            assert torch.equal(got, mult(x))
    a, x, b = golden_c_problem(mb=40, lm=8)
    with autotune.environment({"TFQ_SOLVER_SUPER": "2",
                               "TFQ_PAIRS_MM_PREC": mode}):
        s = Solver(a, x, b, precision="c", engine="pairs", device="cuda")
    assert s._multiply.lm == 16 and s._multiply.mode == mode
    assert _maxdev((s._multiply(s._v3),),
                   (s._multiply.plain(s._v3),)) <= SPLIT_GATE


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k3"])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16x4"])
def test_split_kernel_keeps_its_products_on_card(mode, kernel):
    """On golden-class cos/sin data the kernel lies no farther from the
    float64 product than 1.05 times its plain version does: a bf16x4
    kernel that dropped A_lo X_lo would sit as far as bf16x3, more than
    1.05 times as far (tests/test_torch_precision.py)."""
    _needs_card()
    plan = create_plan(*golden_class_patterns(mb=24), device="cuda")
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    if kernel == "k3":
        mult, x, _ = _rowtile_multiply(plan, 32, 32, av, xv, "cuda",
                                       precision=mode)
    else:
        mult, x, _ = packed_multiply(plan, 32, 32, av, xv, "cuda", 8,
                                     precision=mode)
    want = f64_product(mult, x)
    dev = _maxdev(tuple(g.double() for g in _as_tuple(mult(x))), want)
    plain_dev = _maxdev(tuple(p.double() for p in _as_tuple(mult.plain(x))),
                        want)
    assert dev <= 1.05 * plain_dev, (dev, plain_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,knob", [("pairs", "TFQ_PAIRS_MM_PREC"),
                                         ("pallas", "TFQ_PALLAS_MM_PREC")])
def test_split_solve_launches_the_split_kernel_on_card(engine, knob):
    """A 'c' solve under the knob sends every multiply through the split
    kernel and none through the FP32 one."""
    _needs_card()
    a, x, b = golden_c_problem(mb=40, lm=16)
    with autotune.environment({knob: "bf16x6"}):
        s = Solver(a, x, b, precision="c", engine=engine, device="cuda")
    cls = PairPanelMultiply if engine == "pairs" else RowTileMultiply
    cls.launches = cls.split_launches = 0
    info = s.solve(tolerance=1e-5, max_iterations=300)
    assert info.return_status == 0
    assert cls.launches == 0
    assert cls.split_launches == 2 * info.iterations_needed + info.n_probes


# the shapes of the warpgroup design; K3's 'bf16' runs its FP32 kernel
SPLIT_SHAPE_CASES = [(case, mode) for case in SPLIT_SHAPES
                     for mode in SPLIT_MODES
                     if not (case[0] == "k3" and mode == "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,mode", SPLIT_SHAPE_CASES)
def test_split_kernel_shapes_on_card(case, mode):
    """The split kernel at the shapes of its warpgroup design
    (``chip_smoke.SPLIT_SHAPES``: LM 4 and 8 in K3, lanes that 16 or 128 do
    not divide, the narrow CTA, two tiles a unit where a tile lacks a block
    at a union step, dead unit rows, two units a tile, LM 64) against its
    plain version within ``SPLIT_GATE``, and the same bits on a repeat,
    from a misaligned x and from work lists of 1, 7 and units/2 CTAs (fewer
    than the units); one X split pass a multiply."""
    _needs_card()
    cls = RowTileMultiply if case[0] == "k3" else PairPanelMultiply
    before = (cls.split_launches, pt.XSplit.launches)
    check_staged(lambda slots: split_case(*case, mode, "cuda", slots),
                 f"{case} {mode}", SPLIT_GATE)
    n = cls.split_launches - before[0]
    assert n == 6 and pt.XSplit.launches - before[1] == n


def _split_values(rng) -> np.ndarray:
    """Normal, tiny, subnormal and huge float32 values, NaNs with payloads,
    infinities and rounding ties of the bf16 splits."""
    tiny, fmax = np.finfo(np.float32).tiny, np.finfo(np.float32).max
    words = np.array([0x7FC12345, 0xFFA00001, 0x7F800001, 0x7FFF8000,
                      0x7F800000, 0xFF800000, 0x3F808000, 0xBF808000,
                      0x00008000, 0x80408000, 0x00000001], np.uint32)
    ties = ((rng.integers(0x3000, 0x4800, 300).astype(np.uint32) << 16)
            | 0x8000).view(np.float32)
    return np.concatenate([
        rng.standard_normal(1000).astype(np.float32),
        (rng.standard_normal(500) * 10.0 ** rng.uniform(-30, 30, 500)
         ).astype(np.float32),
        (rng.uniform(-1, 1, 200) * tiny).astype(np.float32),
        (fmax * (1 - rng.uniform(0, 2.0 ** -8, 100))).astype(np.float32),
        words.view(np.float32), ties])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SPLIT_MODES)
def test_split_x_pass_matches_plain_on_card(mode):
    """The X split pass (csrc/split_x_bf16.cu) equals its plain version
    ``paneltiles.x_planes``, ``split_planes``' bits on the CPU, to the bit,
    NaN payloads, infinities, subnormals and ties included: from K3's
    separate halves, K2's lane halves of one fused panel and a misaligned
    panel; one launch a call."""
    _needs_card()
    rng = np.random.default_rng(25)
    vals = _split_values(rng)
    for lm, c in ((8, 21), (32, 48), (16, 130), (4, 5)):
        rows = 6 * lm
        fused = torch.from_numpy(rng.choice(vals, (rows, 2 * c)))
        want = pt.x_planes(fused[:, :c], fused[:, c:], lm, mode)
        xs = pt.XSplit(rows, lm, c, mode, "cuda")
        on = fused.cuda()
        for hr, hi in ((on[:, :c].contiguous(), on[:, c:].contiguous()),
                       (on[:, :c], on[:, c:]),
                       (_misaligned(on)[:, :c], _misaligned(on)[:, c:])):
            before = pt.XSplit.launches
            got = xs(hr, hi)
            torch.cuda.synchronize()
            assert pt.XSplit.launches == before + 1
            assert torch.equal(got.cpu().view(torch.int16),
                               want.view(torch.int16)), (lm, c)


# ------------------------------------------------- K1's Ozaki modes (oz)

def _oz(rng, case, lm, ln, group, r_tile, device):
    """The oz kernel's multiply in the body ``case`` on a random packed
    plan, and a fused float64 X with wide exponents and float64 lanes."""
    plan = create_plan(*random_problem(rng, mb=12, lm=lm, ln=ln, ncols=4),
                       device=device)
    gp, pplan = pack_plan(plan, lm, ln, group, r_tile)
    mult = oz_multiply(pplan, wide_blocks(rng, plan.nnzb_a, lm, lm), device,
                       case)
    x = fused_x(pplan, gp, wide_blocks(rng, plan.nnzb_x, lm, ln, lanes=True),
                torch.float64, device)
    return mult, x


def test_cpu_oz_multiply_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    before = pp.OzPairPanelMultiply.launches
    for case in OZ_CASES:
        lm, ln = oz_sizes(case)[0]
        mult, x = _oz(np.random.default_rng(30), case, lm, ln, 2, 1, "cpu")
        assert torch.equal(mult(x), mult.plain(x))
    assert pp.OzPairPanelMultiply.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OZ_CASES))
def test_oz_kernel_matches_plain_on_card(case):
    """The oz kernel's output equals its plain version's to the bit (the
    slice products are exact, so any order of their sums gives the same
    bits), and again on a repeat: at the kernel block sizes with LM >= 16
    x G (1, 2) x r_tile (1, 2)."""
    _needs_card()
    rng = np.random.default_rng(31)
    for lm, ln in oz_sizes(case):
        for group in (1, 2):
            for r_tile in (1, 2):
                mult, x = _oz(rng, case, lm, ln, group, r_tile, "cuda")
                check_oz(mult, x, f"{case} ({lm}, {ln}) G {group} r_tile "
                         f"{r_tile}")


@pytest.mark.parametrize("case", list(OZ_RANDOM))
def test_cpu_oz_random_cases_take_the_plain_version(monkeypatch, case):
    """The card tests' random oz shapes build on the CPU, where the wrapper
    is the plain version and builds nothing; the kernel's A slices are the
    plain version's, int8 ones re-scaled into bf16 exactly."""
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    before = pp.OzPairPanelMultiply.launches
    for shape in OZ_SHAPES:
        mult, xw = oz_random_case(case, shape, "cpu")
        assert xw.t().is_contiguous()
        assert torch.equal(mult.body_out(xw), mult.body_plain(xw))
        rescale = mult.a_int8 and not mult.xi8
        want = mult.planes.double()
        if rescale:
            want = (want.view(mult.ntiles, mult.p, -1) * torch.tensor(
                [2.0 ** (-(s + 1) * mult.q) for s in range(mult.p)],
                dtype=torch.float64)[None, :, None]).view(want.shape)
        esz = 1 if mult.xi8 else 2
        for stage_bytes in (32, 64):
            if (mult.lm * esz) % stage_bytes:
                continue
            staged = pp.oz_kernel_planes(mult.planes, mult.p, mult.q,
                                         mult.m, rescale, stage_bytes)
            assert torch.equal(
                _unstage(staged, mult.m, stage_bytes).double(), want)
    assert pp.OzPairPanelMultiply.launches == before


def _unstage(staged: torch.Tensor, m: int, stage_bytes: int) -> torch.Tensor:
    """The A slices [nt, p*2m, K] back from the oz kernel's staged layout
    [nt, row blocks, stages, p, 2, 32 rows, chunks, 16 bytes] (the swizzle:
    chunk c of row r stored at c ^ (r*stage_bytes/128 mod chunks)), by index
    arithmetic of its own."""
    nt, nrb, nst, p, _, hr, chunks, w = staged.shape
    out = torch.empty((nt, p, 2, nrb * hr, nst, chunks, w),
                      dtype=staged.dtype)
    for r in range(hr):
        x = (r * stage_bytes // 128) % chunks
        for c in range(chunks):
            for rb in range(nrb):
                out[:, :, :, rb * hr + r, :, c] = staged[
                    :, rb, :, :, :, r, c ^ x].permute(0, 2, 3, 1, 4)
    return out[:, :, :, :m].reshape(nt, p * 2 * m, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(OZ_SHAPES))
@pytest.mark.parametrize("case", list(OZ_RANDOM))
def test_oz_kernel_shapes_on_card(case, shape):
    """The oz kernel's edge shapes to the bit against its plain version, and
    again on a repeated launch: 2M of 32 (rows past it zero in the wgmma
    block) and of 128 (two row blocks), lane counts whose last lane block
    reaches past LN, unions shorter than ku (kcount 0 to ku-1), each body's
    largest p ('ozc' 9, 'xi8' 9, 'oz' 14, each A type), and LM 4 and 8
    (slots padded with zero rows to 16)."""
    _needs_card()
    mult, xw = oz_random_case(case, shape, "cuda", seed=len(shape))
    check_oz_slices(mult, xw, f"{case} {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OZ_BOUND))
def test_oz_kernel_exact_at_its_depth_bound_on_card(case):
    """Every slice at full scale and of one sign, at the deepest
    contraction the body admits: the tensor cores' float32 (or int32) sums
    lose no bit."""
    _needs_card()
    mult, xw = oz_bound_case(case, "cuda")
    got, want = mult.body_out(xw), mult.body_plain(xw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_oz_solve_launches_the_oz_kernel_on_card():
    """A 'z' 'pairs' solve under TFQ_PAIRS_Z_OZ=1 sends every multiply
    through the oz kernel ('xi8' at LM 32) and none through K1, and gives
    K1's solution to 1e-10."""
    _needs_card()
    a, x, b = golden_z_problem(mb=24, ncols=4)
    with autotune.environment({"TFQ_PAIRS_Z_OZ": "1"}):
        s = Solver(a, x, b, precision="z", engine="pairs", device="cuda")
    assert s._multiply.body == "xi8"
    k1 = Solver(a, x, b, precision="z", engine="pairs", device="cuda")
    pp.OzPairPanelMultiply.launches = PairPlanMultiply.launches = 0
    info = s.solve(tolerance=1e-10, max_iterations=300)
    assert info.return_status == 0 and PairPlanMultiply.launches == 0
    assert pp.OzPairPanelMultiply.launches == (2 * info.iterations_needed
                                               + info.n_probes)
    k1.solve(tolerance=1e-10, max_iterations=300)
    got, want = s.get_matrix("X"), k1.get_matrix("X")
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


# ------------------------------------------------ the loop as a CUDA graph

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32), (3, 8)])
def test_loop_control_kernels_match_plain_on_card(shape):
    """The control kernels of csrc/loop_control.cu against core.decide,
    core.settle and LoopControl.running on the card, to the bit, over phase
    22 (a)'s carry states: a tie of the bound with its target, the cap,
    every RHS broken, a NaN column, a zero column of B, residuals at the
    underflow guard."""
    _needs_card()
    from chip_smoke import check_loop_control
    from tfqmrgpu_tpu_torch.graphloop import LoopControl

    def single():
        return (LoopControl.decides + LoopControl.settles
                + LoopControl.continues)

    before, every = single(), LoopControl.launches
    assert check_loop_control(torch.device("cuda"), shape) == 10
    assert single() == before + 10 * 5
    # and each state's sharded stages (check_sharded_stages): 2 local
    # stages at keep_nan True and False, 2 finish stages on 9 partials
    assert LoopControl.launches == every + 10 * (5 + 4 + 18)


def _loop_solver(case):
    if case in ("k1", "dense"):
        a, x, b = golden_z_problem(mb=24, ncols=4)
        return Solver(a, x, b, precision="z",
                      engine="pairs" if case == "k1" else "dense",
                      device="cuda"), 1e-10
    a, x, b = golden_c_problem(mb=24, ncols=4)
    return Solver(a, x, b, precision="c",
                  engine="pallas" if case == "k3" else "pairs",
                  device="cuda"), 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1", "k3", "k2", "dense"])
def test_loop_graph_matches_plain_driver_on_card(case):
    """One graph launch a solve, and the plain driver's iterations, probes,
    statuses and X: to the bit on the hand-written kernels, within 1e-12
    on 'dense' (cuBLAS)."""
    _needs_card()
    from chip_smoke import plain_driver
    from tfqmrgpu_tpu_torch.graphloop import LoopControl, LoopGraph

    s, tol = _loop_solver(case)
    counts = (LoopGraph.launches, LoopGraph.reads)
    LoopControl.launches = 0
    info = s.solve(tolerance=tol, max_iterations=300)
    assert (LoopGraph.launches - counts[0], LoopGraph.reads - counts[1]) \
        == (1, 1)
    its = info.iterations_needed
    assert (LoopControl.decides, LoopControl.continues,
            LoopControl.settles) == (its, its + 1, info.n_probes)
    x = s.get_matrix("X")
    with plain_driver():
        plain = s.solve(tolerance=tol, max_iterations=300)
    assert LoopGraph.launches - counts[0] == 1
    assert info.return_status == plain.return_status == 0
    assert (info.iterations_needed, info.n_probes) == (
        plain.iterations_needed, plain.n_probes)
    assert np.array_equal(info.rhs_status, plain.rhs_status)
    want = s.get_matrix("X")
    if case == "dense":
        assert np.max(np.abs(x - want)) <= 1e-12 * np.max(np.abs(want))
    else:
        assert np.array_equal(x, want)


@pytest.mark.cuda
def test_loop_graph_replays_without_capture_on_card():
    """A second solve with another B and tolerance replays the graph (no
    capture) and gives a fresh Solver's bits; the launch counters count
    2 K1 launches an iteration and 1 a probe."""
    _needs_card()
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    a, x, b = golden_z_problem(mb=24, ncols=4)
    s = Solver(a, x, b, precision="z", engine="pairs", device="cuda")
    s.solve(tolerance=1e-10, max_iterations=300)
    b2 = np.random.default_rng(5).standard_normal(b.data.shape + (2,)) \
        @ [1, 1j]
    s.set_matrix("B", b2)
    captures = LoopGraph.captures
    PairPlanMultiply.launches = 0
    info = s.solve(tolerance=1e-8, max_iterations=300)
    assert LoopGraph.captures == captures
    assert PairPlanMultiply.launches == (2 * info.iterations_needed
                                         + info.n_probes)
    fresh = Solver(a, x, b.with_data(b2), precision="z", engine="pairs",
                   device="cuda")
    want = fresh.solve(tolerance=1e-8, max_iterations=300)
    assert (info.iterations_needed, info.n_probes) == (
        want.iterations_needed, want.n_probes)
    assert np.array_equal(s.get_matrix("X"), fresh.get_matrix("X"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1", "k3"])
def test_loop_graph_replays_after_a_new_a_on_card(case):
    """A new A of the plan goes into the multiply the graph captured: the
    next solve replays it (no capture), the card counts 2 launches an
    iteration and 1 a probe, and X is a fresh Solver's to the bit."""
    _needs_card()
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    s, tol = _loop_solver(case)
    s.solve(tolerance=tol, max_iterations=300)
    kernel = PairPlanMultiply if case == "k1" else RowTileMultiply
    a, x, b = (golden_z_problem if case == "k1" else golden_c_problem)(
        mb=24, ncols=4)
    a2 = a.data * (1.0 + 0.1 * np.random.default_rng(3).random(
        (a.nnzb, 1, 1)))
    captures, mult = LoopGraph.captures, s._multiply
    s.set_matrix("A", a2)
    kernel.launches = 0
    info = s.solve(tolerance=tol, max_iterations=300)
    assert LoopGraph.captures == captures and s._multiply is mult
    assert kernel.launches == 2 * info.iterations_needed + info.n_probes
    fresh = Solver(a.with_data(a2), x, b, precision=s.precision,
                   engine=s.engine, device="cuda")
    want = fresh.solve(tolerance=tol, max_iterations=300)
    assert (info.iterations_needed, info.n_probes, info.return_status) == (
        want.iterations_needed, want.n_probes, want.return_status)
    assert np.array_equal(s.get_matrix("X"), fresh.get_matrix("X"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1", "k3"])
def test_loop_graph_spans_on_card(case):
    """Recording, a first solve keeps the capture's spans from the clock
    readings that ``capture_parts`` gives, and each solve's fill, launch
    (with the graph's device time from its event pair) and read; a new A
    refills the graph (``hit``) and its solve captures nothing."""
    _needs_card()
    from tfqmrgpu_tpu_torch import profiling
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    s, tol = _loop_solver(case)
    a, _, _ = (golden_z_problem if case == "k1" else golden_c_problem)(
        mb=24, ncols=4)
    profiling.clear_spans()
    with profiling.recording():
        first = s.solve(tolerance=tol, max_iterations=300)
        s.set_matrix("A", a.data * 1.01)
        second = s.solve(tolerance=tol, max_iterations=300)
    spans = profiling.spans()
    profiling.clear_spans()
    solves = [sp for sp in spans if sp.name == f"tfq.solve.{s.engine}"]
    assert len(solves) == 2
    kids = [[sp for sp in spans if sp.parent == top.id] for top in solves]
    assert [sorted(sp.name for sp in k) for k in kids] == [
        ["capture", "fill", "finish", "launch", "prepare", "read"],
        ["fill", "finish", "launch", "prepare", "read"]]
    capture = next(sp for sp in kids[0] if sp.name == "capture")
    graph = next(iter(s.loop_graphs._graphs.values()))
    assert (capture.end_ns - capture.start_ns) / 1e9 == graph.capture_s
    parts = {sp.name: (sp.end_ns - sp.start_ns) / 1e9 for sp in spans
             if sp.parent == capture.id}
    assert parts == graph.capture_parts
    for k, info in zip(kids, (first, second)):
        launch = next(sp for sp in k if sp.name == "launch")
        ms = launch.attrs["device_ms"]
        top = solves[kids.index(k)]
        assert 0 < ms < (top.end_ns - top.start_ns) / 1e6
        assert info.return_status == 0
    assert [sp.attrs for sp in spans if sp.name == "refill"] == [
        {"hit": True}]
    launches = LoopGraph.launches
    s.solve(tolerance=tol, max_iterations=300)
    assert LoopGraph.launches == launches + 1


@pytest.mark.cuda
def test_failed_capture_raises_on_card(monkeypatch):
    """A host read inside the captured loop makes the capture fail: the
    solve raises and never runs the plain driver; the next solve captures
    and runs."""
    _needs_card()
    from tfqmrgpu_tpu_torch import core
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    residual = core.probe_residual

    def host_read(*args):
        res2 = residual(*args)
        float(res2.sum())                   # a device-to-host read
        return res2

    def refuse(*args):
        raise AssertionError("a CUDA solve reached the plain driver")

    s, tol = _loop_solver("k1")
    monkeypatch.setattr(core, "probe_residual", host_read)
    monkeypatch.setattr(core, "plain_loop", refuse)
    launches = LoopGraph.launches
    with pytest.raises(RuntimeError):
        s.solve(tolerance=tol, max_iterations=300)
    assert LoopGraph.launches == launches and len(s.loop_graphs) == 0
    monkeypatch.setattr(core, "probe_residual", residual)
    info = s.solve(tolerance=tol, max_iterations=300)
    assert info.return_status == 0 and LoopGraph.launches == launches + 1


# ------------------------------------------- the sharded loop as a CUDA graph

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32), (3, 8)])
def test_sharded_stages_match_plain_on_card(shape):
    """The sharded stages of the loop's control (decide_local /
    decide_finish, settle_local / settle_finish) against core's on the card,
    to the bit, over phase 22 (a)'s carry states, on a mesh of one rank
    (keep_nan) and of more, the finish stages also on reduced partials no
    rank sends alone; each stage counts its launches on the card."""
    _needs_card()
    from chip_smoke import check_sharded_stages, loop_control_table
    from tfqmrgpu_tpu_torch.graphloop import LoopControl

    dev = torch.device("cuda")
    LoopControl.launches = 0
    rows = loop_control_table(shape)
    for name, tau, inv, status, it, maxit, target, res2, tol2, bound2 \
            in rows:
        check_sharded_stages(
            dev, name, tau, torch.from_numpy(inv).to(dev), status, it,
            torch.tensor(maxit, dtype=torch.int32, device=dev), target, res2,
            tol2, bound2)
    n = len(rows)
    assert (LoopControl.decide_locals, LoopControl.settle_locals,
            LoopControl.decide_finishes, LoopControl.settle_finishes) == (
        2 * n, 2 * n, 9 * n, 9 * n)
    assert LoopControl.decides == LoopControl.settles == 0


def _sharded_solve(case, mesh):
    """(solve() -> (X, info), the kernel's wrapper, the solver or None) at
    a small golden-class size: 'k1' ``sharded_solve`` in 'z', 'k3'
    ``ShardedRowTileSolver`` and 'k2' ``ShardedPairsSolver`` in 'c'."""
    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsSolver,
                                             ShardedRowTileSolver,
                                             partition_plan, sharded_solve)

    a, x, b = (golden_z_problem if case == "k1" else golden_c_problem)(
        mb=24, ncols=4)
    plan = create_plan(a, x, b, device="cuda")
    plan.lm = plan.ln = 32
    if case == "k1":
        part = partition_plan(plan, 1, 1)

        def solve():
            xr, xi, info = sharded_solve(
                plan, part, mesh, a.data.real, a.data.imag, b.data.real,
                b.data.imag, tolerance=1e-10, max_iterations=300)
            return xr + 1j * xi, info
        return solve, PairPlanMultiply, None
    sp = (ShardedRowTileSolver if case == "k3" else ShardedPairsSolver)(
        plan, mesh)
    return (lambda: sp.solve(a.data.real, a.data.imag, b.data.real,
                             b.data.imag, tolerance=1e-5,
                             max_iterations=300),
            RowTileMultiply if case == "k3" else PairPanelMultiply, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1", "k3", "k2"])
def test_sharded_graph_matches_plain_driver_on_card(nccl_mesh, case):
    """A sharded solve at world size 1 on NCCL is one graph launch and one
    state read (the collectives and the sharded stages in the WHILE body),
    and the plain driver's on the same mesh to the bit: iterations,
    probes, kernel launches and collectives of each kind, read from the
    card's counters."""
    from chip_smoke import SHARDED_STAGES, sharded_both

    solve, kernel, _ = _sharded_solve(case, nccl_mesh)
    r = sharded_both(nccl_mesh, solve, {"kernel": kernel})
    its, probes = r["info"]["iterations"], r["info"]["n_probes"]
    assert r["info"]["return_status"] == 0
    assert r["launches"]["kernel"] == 2 * its + probes
    assert r["stages"] == dict(zip(SHARDED_STAGES,
                                   (its, its, probes, probes)))
    assert r["calls"]["all_reduce"] == 5 * its + 2 * probes + 1


@pytest.mark.cuda
def test_mesh_calls_read_and_reset_on_card(nccl_mesh):
    """``Mesh.calls`` on the card reads the collectives counted there and
    ``clear()`` resets them; under ``launch_counts.uncounted()`` (a graph's
    warm-up) nothing is counted."""
    from tfqmrgpu_tpu_torch import core, launch_counts

    t = torch.ones(4, dtype=torch.float64, device="cuda")
    nccl_mesh.calls.clear()
    assert [nccl_mesh.calls[k] for k in
            ("all_gather", "all_reduce", "neighbour_exchange")] == [0, 0, 0]
    nccl_mesh.psum(t)
    nccl_mesh.reduce_max(torch.zeros(2, dtype=torch.float64, device="cuda"))
    nccl_mesh.gather(t)
    assert (nccl_mesh.calls["all_reduce"], nccl_mesh.calls["all_gather"]) \
        == (2, 1)
    with launch_counts.uncounted():
        nccl_mesh.psum(t)
    assert nccl_mesh.calls["all_reduce"] == 2
    part = core.decision_partials(
        torch.tensor(float("nan"), dtype=torch.float64, device="cuda"),
        torch.ones((), dtype=torch.bool, device="cuda"), True)
    assert nccl_mesh.reduce_max(part)[0].isnan() and part[1] == -1
    assert nccl_mesh.calls["all_reduce"] == 3
    nccl_mesh.calls.clear()
    assert nccl_mesh.calls["all_reduce"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k3", "k2"])
def test_sharded_set_matrix_a_replays_without_capture_on_card(nccl_mesh,
                                                              case):
    """A new A through ``set_matrix_a`` goes into the K3 / K2 the sharded
    solver's graph captured: the next solve replays it (no capture) and
    gives a fresh solver's X to the bit."""
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    solve, kernel, sp = _sharded_solve(case, nccl_mesh)
    solve()
    captures = LoopGraph.captures
    info = solve()
    assert LoopGraph.captures == captures
    a, x, b = golden_c_problem(mb=24, ncols=4)
    a2 = a.data * (1.0 + 0.1 * np.random.default_rng(4).random(
        (a.nnzb, 1, 1)))
    sp.set_matrix_a(a2.real, a2.imag)
    kernel.launches = 0
    x_new, info = sp.solve(a2.real, a2.imag, b.data.real, b.data.imag,
                           tolerance=1e-5, max_iterations=300)
    assert LoopGraph.captures == captures and len(sp.loop_graphs) == 1
    assert kernel.launches == 2 * info["iterations"] + info["n_probes"]
    fresh = type(sp)(sp.plan, nccl_mesh)
    x_want, want = fresh.solve(a2.real, a2.imag, b.data.real, b.data.imag,
                               tolerance=1e-5, max_iterations=300)
    assert info["iterations"] == want["iterations"]
    assert np.array_equal(x_new, x_want)



@pytest.mark.cuda
def test_shutdown_closes_held_sharded_graphs_on_card():
    """``multihost.shutdown`` closes the loop graph of a sharded solver that
    is still held, then destroys the process group."""
    _needs_card()
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch.parallel import make_mesh, multihost

    if dist.is_initialized():
        pytest.skip("a process group of another test is up")
    multihost.initialize(device="cuda:0")
    try:
        solve, _, sp = _sharded_solve("k3", make_mesh(1, 1, device="cuda:0"))
        solve()
        (graph,) = sp.loop_graphs._graphs.values()
        assert graph.exec is not None
    finally:
        multihost.shutdown()
    assert graph.exec is None and graph.pool is None
    assert not dist.is_initialized()


# ------------------------------------------------ the loop's vector passes

# the cell's points (of 16) whose iterations differ by one between the
# kernels and the torch passes on an H100 (PERF.md §6)
CELL_POINTS_OFF_BY_ONE = ()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vector_passes_match_plain_on_card(dtype):
    """Each kernel of csrc/vector_passes.cu against its plain version at
    the benchmark cell's shapes (28,215 blocks of 8 x 8 in 27 columns):
    axpy, xpay and add_rhs to the bit (linalg's bits too), dotp and nrm2 to
    the bit and the same on a repeat, within the stated tolerance of
    linalg's (``check_vector_passes``); the card counts each launch."""
    _needs_card()
    from chip_smoke import cell_problem, cell_solver, check_vector_passes
    from tfqmrgpu_tpu_torch.ops.linalg import VectorPasses

    dev = torch.device("cuda")
    prob, work = cell_problem(dev)
    s = cell_solver(prob, work[0], dev)
    vp = VectorPasses(s._cols, s.plan.subset)
    assert (vp.colindx.shape[0], vp.cols.ncols, s.lm, s.ln) == (28215, 27,
                                                                8, 8)
    VectorPasses.launches = 0
    assert check_vector_passes(vp, s.lm, s.ln, dtype, dev) <= 1.0
    # axpy, xpay, two add_rhs; four dotp and two nrm2 of two stages each
    assert (VectorPasses.axpays, VectorPasses.scatters, VectorPasses.partials,
            VectorPasses.column_sums) == (2, 2, 6, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lm,ln", [(3, 5), (4, 6), (16, 4)])
def test_vector_passes_odd_lanes_match_plain_on_card(dtype, lm, ln):
    """The kernels' one-element path, taken where a row's lanes are no
    multiple of a 16-byte access (LN 5; LN 6 in float32), and the 16-byte
    path at LN 4, on a ragged pattern with an empty column: the same
    checks as at the cell's shapes."""
    _needs_card()
    from chip_smoke import check_vector_passes
    from tfqmrgpu_tpu_torch.ops import linalg

    dev = torch.device("cuda")
    rng = np.random.default_rng(lm * 10 + ln)
    colindx = np.repeat(np.arange(6), (3, 150, 0, 40, 1, 9))
    rng.shuffle(colindx)
    cols = linalg.columns(torch.from_numpy(colindx.astype(np.int32)).to(dev),
                          6)
    subset = torch.from_numpy(rng.permutation(colindx.shape[0])[:11].astype(
        np.int32)).to(dev)
    vp = linalg.VectorPasses(cols, subset)
    assert check_vector_passes(vp, lm, ln, dtype, dev) <= 1.0


@pytest.mark.cuda
def test_vector_passes_in_the_cell_solve_on_card():
    """A 'pairs' 'z' solve of the cell's FD problem through the graph: the
    recorded step writes v1, v4, v5, v6 and v7 in place, so the body holds
    no X-shaped copy but v8's; the card counts 18 vector pass launches an
    iteration, 3 a probe and 3 in prepare (``check_first_solve``); on the
    cell's 16 energies the iterations are the torch passes' on the card,
    but at the points PERF.md names, by one."""
    _needs_card()
    from chip_smoke import (cell_problem, cell_solver, check_first_solve,
                            contour_against_torch)

    dev = torch.device("cuda")
    prob, work = cell_problem(dev)
    info, _ = check_first_solve(cell_solver(prob, work[0], dev))
    assert info.return_status == 0
    kernels, plain, differ = contour_against_torch(prob, work, dev)
    assert len(kernels["iterations"]) == 16
    assert tuple(differ) == CELL_POINTS_OFF_BY_ONE


def test_cpu_solve_runs_linalgs_passes(monkeypatch):
    """On the CPU ``core.solve_core`` runs ``linalg``'s functions, as
    before the kernels: no ``VectorPasses`` is made."""
    from tfqmrgpu_tpu_torch.ops import linalg

    def refuse(*args):
        raise AssertionError("a CPU solve made VectorPasses")

    monkeypatch.setattr(linalg, "VectorPasses", refuse)
    s = Solver(*golden_z_problem(mb=24, ncols=4), precision="z",
               engine="pairs", device="cpu")
    assert s.solve(tolerance=1e-10, max_iterations=300).return_status == 0


# ------------------------------------- the benchmark's 64-point FD blocks

# the cell's points (of 16) whose iterations the test holds against the
# reference's: E = 0.50 + 0.17i in the band beside the axis (the heaviest),
# one halfway round, and E = -20.0 + 0.17i below the band
FD64_POINTS = (0, 8, 15)
# |iterations - the reference's| at those points: 2 at the first (219
# against 221 on an H100), where the recurrences amplify rounding and the
# true residual at a probe lies near the tolerance, so another order of
# the sums moves the stop by a probe (the CPU's 'dense' and 'pairs' take 2
# more than the reference there, tests/test_torch_fd64.py); 0 at the others
FD64_ITER_GAP = 2


@pytest.mark.cuda
def test_fd64_cell_solves_on_k1_in_the_graph_on_card():
    """The benchmark cell fd64_z.contour (461 block rows of 64 x 64, 1,728
    right-hand sides) as the benchmark runs it: 'auto' takes 'pairs'; the
    first solve captures the loop graph and runs every multiply on K1's
    (64, 64) instantiation, 2 an iteration and 1 a probe by the card's
    counter; at three contour points the iterations lie within
    ``FD64_ITER_GAP`` of the plain reference's (``benchmark/reference``)
    and X within the cell's limits of the judge."""
    _needs_card()
    from benchmark import cells, pool, problems
    from benchmark.reference import judge
    from chip_smoke import cell_solver
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    dev = torch.device("cuda")
    cell = cells.load("fd64_z.contour")
    tol, maxit = cell.config["tolerance"], cell.config["max_iterations"]
    prob = problems.build(cell.config, 0, dev)
    sigma = pool.shifts(cell.points)
    work = pool.make_pool(prob, sigma[list(FD64_POINTS)])
    s = cell_solver(prob, work[0], dev)
    assert s.engine == "pairs" and (s.lm, s.ln) == (64, 64)
    assert (s._multiply.schedule.warps_m, s._multiply.schedule.warps_n) == (
        2, 2)
    got = []
    for j, a in enumerate(work):
        s.set_matrix("A", a)
        k1, graphs, captures = (PairPlanMultiply.launches,
                                LoopGraph.launches, LoopGraph.captures)
        info = s.solve(tolerance=tol, max_iterations=maxit)
        torch.cuda.synchronize()
        assert info.return_status == 0
        assert PairPlanMultiply.launches - k1 == (
            2 * info.iterations_needed + info.n_probes)
        assert LoopGraph.launches - graphs == 1
        assert LoopGraph.captures - captures == (1 if j == 0 else 0)
        got.append((s.get_matrix("X"), info.iterations_needed))
    del s
    torch.cuda.empty_cache()
    for a, (x, its) in zip(work, got):
        r = judge.read(prob, a, x, its, tol, maxit, dev)
        assert r["ref_status"] == 0 and r["iter_gap"] <= FD64_ITER_GAP, r
        assert all(r[k] <= cell.config["limits"][k] for k in ("resid",
                                                               "xdev")), r

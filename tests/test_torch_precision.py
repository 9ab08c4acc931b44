"""The bf16 split precision modes of the port's 'c' engines against the JAX
package's on the CPU.

* The splits ``rn16_f32``, ``split_bf16x2`` and ``split_bf16x3`` are the
  JAX package's to the bit: random normal values, subnormals, +-0 and values
  within 2^-8 of the float32 maximum (where the rounding carries into
  infinity).  ``precision_props`` equals JAX's for the five modes.
* Each split mode's plain K2 and K3 against the TPU kernels run in
  interpret mode at the same precision, within 1e-5 of the largest entry
  (float32 sums of the same exact bf16 products in another order).
* Whole solves under TFQ_PAIRS_MM_PREC and TFQ_PALLAS_MM_PREC in both
  packages (the JAX plan and v3 handed over): the same status, iterations
  within 1, X within 1e-4, and for 'bf16x6' a float64 residual below 1e-4.
* The JAX package's two coercions (the packed engine at a kernel LM below
  16, K3's 'bf16'), the ValueError on an unknown string, the sharded
  constructors at 2 gloo ranks, and ``solver_roofline``'s ``mm_passes``.
* On golden-class cos/sin data bf16x3's plain version lies more than 1.05
  times as far from the float64 product as bf16x4's, so the smoke's gate
  at 1.05 times the plain version's deviation tells the two apart.

The Hopper kernels themselves are tested on the card by
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfqmrgpu_tpu_torch as tt
from chip_smoke import (_as_tuple, _maxdev, _rowtile_multiply, cos_sin,
                        f64_product, golden_class_patterns, packed_multiply)
from conftest import dense_from_bsr, make_random_problem
from test_pairpanel import _bsr_pair_plan
from test_torch_panel import _plans, _port
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.ops import pairpanel as jpp
from tfqmrgpu_tpu.ops import pallas_spmm as jrt
from tfqmrgpu_tpu_torch import convert, profiling
from tfqmrgpu_tpu_torch import solver as tsolver
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp
from tfqmrgpu_tpu_torch.ops import pallas_spmm as trt
from tfqmrgpu_tpu_torch.ops import paneltiles
from tfqmrgpu_tpu_torch.ops.panel import PanelLayout
from torch_sharded_worker import pack_problem, run_ranks

torch.set_num_threads(2)

SPLITS = ("bf16", "bf16x3", "bf16x4", "bf16x6")
F32 = np.float32


def _edge_values(rng) -> np.ndarray:
    fmax, tiny = np.finfo(F32).max, np.finfo(F32).tiny
    return np.concatenate([
        rng.standard_normal(2000).astype(F32),
        (rng.standard_normal(2000) * 10.0 ** rng.uniform(-30, 30, 2000)
         ).astype(F32),
        (rng.uniform(-1, 1, 500) * tiny).astype(F32),            # subnormals
        (rng.uniform(-1, 1, 100) * tiny * 2).astype(F32),        # about FLT_MIN
        np.array([0.0, -0.0, tiny, -tiny, fmax, -fmax], F32),
        (fmax * (1 - rng.uniform(0, 2.0 ** -8, 200))
         * rng.choice([-1, 1], 200)).astype(F32),
    ])


def _bits16(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def test_splits_bit_identical_to_jax():
    v = _edge_values(np.random.default_rng(0))
    assert np.sum((np.abs(v) < np.finfo(F32).tiny) & (v != 0)) > 400
    tv = torch.from_numpy(v)
    got = tpp.rn16_f32(tv).numpy()
    want = np.asarray(jpp.rn16_f32(jnp.asarray(v)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isinf(got).sum() >= 100               # the carry into infinity
    for name in ("split_bf16x2", "split_bf16x3"):
        ts = getattr(tpp, name)(tv)
        js = getattr(jpp, name)(jnp.asarray(v))
        assert len(ts) == len(js)
        for t_plane, j_plane in zip(ts, js):
            assert t_plane.dtype == torch.bfloat16
            assert np.array_equal(_bits16(t_plane), _bits16(j_plane)), name


@pytest.mark.parametrize("mode", tpp.PRECISIONS)
def test_precision_props_equal_jax(mode):
    assert tpp.precision_props(mode) == jpp.precision_props(mode)
    assert tpp.PRECISIONS == jpp.PRECISIONS
    assert tpp.SPLIT_X_PRECISIONS == jpp.SPLIT_X_PRECISIONS


@pytest.mark.parametrize("mode", SPLITS)
def test_bf16_planes_hold_the_split_pairs(mode):
    """The kernel's A plane layout: word (d, r) of a plane holds the bf16
    entries of depth rows 2d (low half) and 2d+1 (high half)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((3, 8, 12)).astype(F32))
    planes = paneltiles.bf16_planes(a, mode)
    want = tpp.split_planes(a, mode)
    assert planes.dtype == torch.int32
    assert tuple(planes.shape) == (len(want), 3, 4, 12)
    halves = planes.view(torch.int16).reshape(len(want), 3, 4, 12, 2)
    got = halves.transpose(3, 4).reshape(len(want), 3, 8, 12).contiguous()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.bfloat16).to(torch.float32), w)


# ------------------------------------------------------- multiply parity

@pytest.mark.parametrize("mode", SPLITS)
def test_k2_split_plain_matches_tile_pipe_interpret(monkeypatch, mode):
    monkeypatch.setenv("TFQ_PAIRS_TILEPIPE", "1")
    rng = np.random.default_rng(5)
    lm = ln = 16
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=6, ncols=2, lm=lm, ln=ln)
    a = rng.standard_normal((na, lm, lm)) + 1j * rng.standard_normal(
        (na, lm, lm))
    x = rng.standard_normal((nx, lm, ln)) + 1j * rng.standard_normal(
        (nx, lm, ln))
    jplan = jpp.pack_pair_plan(pa, px, py, nx, nx, lm, ln, r_tile=1,
                               resident=True)
    tplan = tpp.pack_pair_plan(pa, px, py, nx, nx, lm, ln, r_tile=1)
    panels = tpp.build_a_panels(tplan, a.real.astype(F32),
                                a.imag.astype(F32))
    fused = tpp.permute_x(tplan, x.real.astype(F32), x.imag.astype(F32))
    jm = jpp.make_pairpanel_multiply(jplan, jnp.asarray(panels),
                                     precision=mode, interpret=True)
    want = np.asarray(jm(jnp.asarray(fused)))[: tplan.n_slots * lm]
    tm = tpp.PairPanelMultiply(tplan, torch.from_numpy(panels),
                               precision=mode)
    before = (tpp.PairPanelMultiply.launches,
              tpp.PairPanelMultiply.split_launches)
    got = tm(torch.from_numpy(fused)).numpy()
    assert (tpp.PairPanelMultiply.launches,
            tpp.PairPanelMultiply.split_launches) == before
    assert tm.units.union and tm.units.bm == paneltiles.MMA_WIDE[0]
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= 1e-5 * scale
    exact = tpp.PairPanelMultiply(tplan, torch.from_numpy(panels))(
        torch.from_numpy(fused)).numpy()
    # the modes differ from exact FP32 as the JAX modes do
    jdev = np.max(np.abs(want - exact)) / scale
    assert np.max(np.abs(got - exact)) / scale <= 2 * jdev + 1e-6


@pytest.mark.parametrize("mode,lm,ln", [
    ("bf16", 8, 8), ("bf16x3", 8, 8), ("bf16x4", 4, 5), ("bf16x6", 16, 16),
    ("bf16x6", 4, 5)])
def test_k3_split_plain_matches_interpret(mode, lm, ln):
    rng = np.random.default_rng(6 + lm)
    mb = 9
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=3)
    _, tp = _plans(a, x, b, lm, ln)
    lay = PanelLayout.from_plan(tp)
    pack = trt.pack_row_tiles(tp.rowptr_a, tp.colind_a, mb, lm, 2)
    are, aim = a.data.real.astype(F32), a.data.imag.astype(F32)
    xp = [lay.pack_x(v) for v in
          rng.standard_normal((2, tp.nnzb_x, lm, ln)).astype(F32)]
    jm = jrt.bsr_panel_multiply(
        jnp.asarray(jrt.build_a_panels(pack, are)),
        jnp.asarray(jrt.build_a_panels(pack, aim)), jnp.asarray(pack.xcols),
        jnp.asarray(lay.mask[:, None, :, None].astype(F32)), mb, lm, lay.ncc,
        ln, interpret=True, precision=mode, t_step=1)
    want = [np.asarray(v) for v in jm(tuple(jnp.asarray(p) for p in xp))]
    tm = trt.RowTileMultiply(
        pack, torch.from_numpy(trt.build_a_panels(pack, are)),
        torch.from_numpy(trt.build_a_panels(pack, aim)), lay.mask, ln,
        precision=mode)
    got = [v.numpy() for v in tm(tuple(torch.from_numpy(p) for p in xp))]
    scale = max(np.abs(w).max() for w in want)
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= 1e-5 * scale
    assert tm.split == (mode != "bf16")


# ----------------------------------------------------------- coercions

def _lm8_problem(seed=40):
    return make_random_problem(np.random.default_rng(seed), mb=10, lm=8,
                               ln=8, ncols=3, dtype=np.complex64)


def test_pairs_below_lm16_runs_highest(monkeypatch):
    """The JAX solver's coercion: at a kernel LM below 16 (no superblock) the
    packed engine runs 'highest' under any TFQ_PAIRS_MM_PREC, to the bit."""
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "0")
    a, x, b = _port(*_lm8_problem())
    xs = []
    for prec in (None, "bf16x3"):
        if prec:
            monkeypatch.setenv("TFQ_PAIRS_MM_PREC", prec)
        s = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
        assert s.pairs_prec == "highest" and s._multiply.mode == "highest"
        info = s.solve(tolerance=1e-5, max_iterations=200)
        assert info.return_status == Status.SUCCESS
        xs.append(s.get_matrix("X"))
    assert np.array_equal(xs[0], xs[1])
    # a superblock at LM' 16 lifts the coercion
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "2")
    s = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    assert s._sup is not None and s._pp_plan.lm == 16
    assert s.pairs_prec == s._multiply.mode == "bf16x3"


def test_k3_bf16_is_highest_to_the_bit():
    rng = np.random.default_rng(41)
    a, x, b = make_random_problem(rng, mb=9, lm=8, ln=8, ncols=3)
    _, tp = _plans(a, x, b, 8, 8)
    lay = PanelLayout.from_plan(tp)
    pack = trt.choose_row_tile(tp, 8)
    panels = [torch.from_numpy(trt.build_a_panels(pack, v.astype(F32)))
              for v in (a.data.real, a.data.imag)]
    xp = tuple(torch.from_numpy(lay.pack_x(v)) for v in
               rng.standard_normal((2, tp.nnzb_x, 8, 8)).astype(F32))
    ys = [trt.RowTileMultiply(pack, *panels, lay.mask, 8, precision=p)(xp)
          for p in ("highest", "bf16")]
    assert all(torch.equal(u, v) for u, v in zip(*ys))


def test_unknown_precision_raises(monkeypatch):
    a, x, b = _port(*_lm8_problem())
    with pytest.raises(ValueError, match="precision must be one of"):
        tpp.check_precision("bf16x5")
    monkeypatch.setenv("TFQ_PAIRS_MM_PREC", "fp8")
    with pytest.raises(ValueError, match="precision must be one of"):
        tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    monkeypatch.delenv("TFQ_PAIRS_MM_PREC")
    monkeypatch.setenv("TFQ_PALLAS_MM_PREC", "tf32")
    with pytest.raises(ValueError, match="precision must be one of"):
        tt.Solver(a, x, b, precision="c", engine="pallas", device="cpu")
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "0")
    monkeypatch.delenv("TFQ_PALLAS_MM_PREC")
    s = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
    with pytest.raises(ValueError, match="LM >= 16"):
        tpp.PairPanelMultiply(s._pp_plan, s._multiply.a_panels,
                              precision="bf16x6")


# --------------------------------------------------------- whole solves

def _c_problem(seed):
    return make_random_problem(np.random.default_rng(seed), mb=8, lm=16,
                               ln=16, ncols=2, x_fill=0.7,
                               dtype=np.complex64)


def _residual(a, x, b, xc) -> float:
    """float64 |A X - B| / |B| over X's pattern."""
    lm, ln = xc.shape[1:]
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(xc), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    pattern = dense_from_bsr(x.with_data(np.ones_like(xc)), lm, ln) != 0
    return float(np.linalg.norm((ad @ xd - bd) * pattern)
                 / np.linalg.norm(bd))


@pytest.mark.parametrize("engine,knob,mode", [
    ("pairs", "TFQ_PAIRS_MM_PREC", "bf16x6"),
    ("pallas", "TFQ_PALLAS_MM_PREC", "bf16x3"),
    ("pallas", "TFQ_PALLAS_MM_PREC", "bf16x4"),
    ("pallas", "TFQ_PALLAS_MM_PREC", "bf16x6")])
def test_split_solve_matches_jax(monkeypatch, engine, knob, mode):
    for k, v in (("TFQ_SOLVER_SUPER", "0"), ("TFQ_PAIRS_RESIDENT", "1"),
                 ("TFQ_PAIRS_TILEPIPE", "1"), ("TFQ_PAIRS_COLGROUP", "1"),
                 (knob, mode)):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tsolver, "choose_group_size", lambda *a, **k: 1)
    a, x, b = _c_problem(90)
    js = jsolver.Solver(a, x, b, precision="c", engine=engine)
    jinfo = js.solve(tolerance=1e-5, max_iterations=300)
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, 16, 16)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="c", engine=engine, plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    assert ts.engine == engine and ts._multiply.mode == mode
    tinfo = ts.solve(tolerance=1e-5, max_iterations=300)
    assert tinfo.return_status == jinfo.return_status == Status.SUCCESS
    assert abs(tinfo.iterations_needed - jinfo.iterations_needed) <= 1
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    if mode == "bf16x6":
        assert _residual(a, x, b, got) < 1e-4


def test_split_modes_reach_the_exact_solution(monkeypatch):
    """The packed engine's other modes in the port alone (the JAX side of
    each costs a 20 s compile): converged to what the mode reaches ('bf16'
    keeps 8 significand bits: 1e-2), and that close to the 'highest'
    solve."""
    monkeypatch.setenv("TFQ_PAIRS_COLGROUP", "2")
    a, x, b = _port(*_c_problem(91))
    gates = {"highest": 1e-5, "bf16": 1e-2, "bf16x3": 1e-4, "bf16x4": 1e-4,
             "bf16x6": 1e-4}
    xs = {}
    for mode in ("highest",) + SPLITS:
        monkeypatch.setenv("TFQ_PAIRS_MM_PREC", mode)
        s = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
        assert s._multiply.mode == mode and s._gp.group_size == 2
        info = s.solve(tolerance=1e-2 if mode == "bf16" else 1e-5,
                       max_iterations=300)
        assert info.return_status == Status.SUCCESS, mode
        xs[mode] = s.get_matrix("X")
    scale = np.max(np.abs(xs["highest"]))
    for mode in SPLITS:
        assert (np.max(np.abs(xs[mode] - xs["highest"]))
                <= gates[mode] * scale), mode


def test_mixed_c_stage_runs_the_knob(monkeypatch):
    """``bsrsv_m``'s c stage is a 'c' Solver, so it takes the knob."""
    monkeypatch.setenv("TFQ_PALLAS_MM_PREC", "bf16x3")
    seen = []
    init = trt.RowTileMultiply.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        seen.append(self.mode)

    monkeypatch.setattr(trt.RowTileMultiply, "__init__", spy)
    a, x, b = _port(*make_random_problem(np.random.default_rng(92), mb=8,
                                         lm=16, ln=16, ncols=2))
    xs, info = tt.bsrsv_m(a, x, b, tolerance=1e-9, engine="pallas",
                          device="cpu")
    assert info.return_status == Status.SUCCESS
    assert seen and set(seen) == {"bf16x3"}
    assert _residual(a, x, b, xs.data) < 1e-8


# ----------------------------------------------------- sharded, roofline

def test_sharded_split_modes_match_the_solver(monkeypatch, tmp_path):
    """ShardedPairsSolver(precision='bf16x6') and
    ShardedRowTileSolver(mm_prec='bf16x3') over 2 gloo ranks against the
    single-device Solver under the same mode (the same v3)."""
    a, x, b = _port(*_c_problem(93))
    inputs = dict(pack_problem(a, x, b), lm=16, ln=16, pr=2, r_tile=2,
                  tol=1e-5, maxit=300, pairs_prec="bf16x6",
                  rowtile_prec="bf16x3")
    out = run_ranks("precision", 2, inputs, tmp_path)
    monkeypatch.setenv("TFQ_PAIRS_MM_PREC", "bf16x6")
    monkeypatch.setenv("TFQ_PALLAS_MM_PREC", "bf16x3")
    monkeypatch.setenv("TFQ_PALLAS_RTILE", "2")
    for engine in ("pairs", "pallas"):
        s = tt.Solver(a, x, b, precision="c", engine=engine, device="cpu")
        info = s.solve(tolerance=1e-5, max_iterations=300)
        want = s.get_matrix("X")
        assert int(out[f"{engine}_return_status"]) == Status.SUCCESS
        assert int(out[f"{engine}_iterations"]) == info.iterations_needed
        got = out[f"{engine}_x"]
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_golden_gate_tells_bf16x4_from_bf16x3(kernel):
    """The smoke's golden-class gate (a kernel within 1.05 times its plain
    version's deviation from the float64 product) fails a bf16x4 kernel
    that runs only bf16x3's products: on cos/sin data bf16x3's plain
    version lies more than 1.05 times as far as bf16x4's."""
    plan = tt.create_plan(*golden_class_patterns(mb=24), device="cpu")
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    devs = {}
    for mode in ("bf16x3", "bf16x4"):
        if kernel == "k3":
            mult, x, _ = _rowtile_multiply(plan, 32, 32, av, xv, "cpu",
                                           precision=mode)
        else:
            mult, x, _ = packed_multiply(plan, 32, 32, av, xv, "cpu", 8,
                                         precision=mode)
        plain = tuple(v.double() for v in _as_tuple(mult.plain(x)))
        devs[mode] = _maxdev(plain, f64_product(mult, x))[0]
    assert devs["bf16x3"] > 1.05 * devs["bf16x4"], devs


def test_roofline_mm_passes(monkeypatch):
    """A split mode's ceiling is the BF16 peak over its bf16 products on the
    H100 row and JAX's 1 TFlop/s over ``mm_passes`` on the "cpu" row;
    ``mm_passes`` is the mode the kernel runs, and a value that contradicts
    it raises."""
    a, x, b = _port(*_c_problem(94))
    monkeypatch.setenv("TFQ_PALLAS_MM_PREC", "bf16x3")
    s = tt.Solver(a, x, b, precision="c", engine="pallas", device="cpu")
    cpu = profiling.solver_roofline(s)
    assert cpu.peak_tflops == pytest.approx(1.0 / 3)   # JAX's cpu row
    assert profiling.solver_roofline(
        s, mm_passes=3).peak_tflops == cpu.peak_tflops
    for wrong in (1, 4, 6):
        with pytest.raises(ValueError, match="3 bf16 products"):
            profiling.solver_roofline(s, mm_passes=wrong)
    monkeypatch.setattr(profiling, "device_kind", lambda d: profiling.H100)
    for mode, passes in tpp.SPLIT_PRODUCTS.items():
        # K3 runs its 'bf16' as 'highest': the modes on K2 (LM 16)
        monkeypatch.setenv("TFQ_PAIRS_MM_PREC", mode)
        m = tt.Solver(a, x, b, precision="c", engine="pairs", device="cpu")
        assert m._multiply.mode == mode
        r = profiling.solver_roofline(m)
        assert r.peak_tflops == pytest.approx(989.0 / passes), mode
        assert profiling.solver_roofline(
            m, mm_passes=passes).peak_tflops == r.peak_tflops
    assert profiling.solver_roofline(s).peak_tflops == pytest.approx(
        989.0 / 3)
    # the A planes: two bf16 planes are the float32 panels' bytes
    monkeypatch.setenv("TFQ_PALLAS_MM_PREC", "highest")
    h = tt.Solver(a, x, b, precision="c", engine="pallas", device="cpu")
    assert profiling.solver_roofline(h).peak_tflops == 67.0
    assert (profiling._a_bytes(h, 4) == profiling._a_bytes(s, 4))
    with pytest.raises(ValueError, match="exact FP32"):
        profiling.solver_roofline(h, mm_passes=6)
    z = tt.Solver(*_port(*make_random_problem(
        np.random.default_rng(95), mb=8, lm=16, ln=16, ncols=2)),
        precision="z", engine="xla", device="cpu")
    with pytest.raises(ValueError, match="FP64"):
        profiling.solver_roofline(z, mm_passes=1)
"""K1's Ozaki modes and the JAX package's packed 'z' route of the 'pairs'
engine (``TFQ_PAIRS_Z_OZ=1``) against the JAX package on the CPU.

* ``oz_mode_params`` and ``precision_props('oz*')`` equal the JAX
  package's over a grid of depths and the knobs TFQ_OZ_COMP,
  TFQ_OZC_INT8 and TFQ_OZ_INT8, its ValueErrors included.
* The slicers (``_oz_slices``, ``_oz_slices_f32pair``,
  ``_oz_slices_int8``) give the JAX package's bits on wide-exponent data
  with zero lanes; the X prologue of ``OzPairPanelMultiply`` gives them
  on lanes outside float32's range too, which take JAX's float64 branch.
* The oz kernel's plain body: its raw output ([M, 4LN] or [2M, p*2LN])
  equals the output of the TPU kernel's Ozaki branches in interpret mode
  to the bit, in 'ozc' (bf16 A, int8 A), the mixed fallback of 'xi8' at
  LM 16, 'xi8' at LM 32 and legacy 'oz' (int8 A, bf16 A), at r_tile 1
  and 2 and on a column-grouped plan (G 2).  The A slices and sigma are
  JAX's to the bit, and the combined product too; it lies within 1e-12 of
  the float64 pair walk.
* ``fused_primitives`` in float64: dotp and nrm2 within 1e-14 of JAX's
  float64 fused primitives and of a float64 sum of the same columns.
* Whole 'z' solves: the port's ``Solver(engine='pairs')`` under
  TFQ_PAIRS_Z_OZ=1 against the JAX Solver's 'z' 'pairs' (the JAX plan and
  v3 handed over, TFQ_PAIRS_COLGROUP pinned, the JAX kernel at
  TFQ_PAIRS_TSTEP=1, which computes the same): the same pack decisions, the
  same iterations and per-RHS status, X within 1e-10; at LM 16, at LM 8
  merged to 16 and at LM 32 ('xi8').  Unset, the Solver builds K1.

The JAX side slices A on its device path (TFQ_OZ_HOST_SLICE=0), the
port's only path, and runs with jax_enable_x64, restored after the module.
"""

import functools
import zlib

import jax
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
from tfqmrgpu_tpu_torch.autotune import environment
from tfqmrgpu_tpu_torch.errors import Status, TfqmrgpuError
from tfqmrgpu_tpu_torch.ops import ozaki as tozaki
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp

torch.set_num_threads(2)

KNOBS = ("TFQ_OZ_COMP", "TFQ_OZC_INT8", "TFQ_OZ_INT8", "TFQ_PAIRS_Z_OZ",
         "TFQ_SOLVER_SUPER", "TFQ_PAIRS_COLGROUP", "TFQ_PAIRS_RTILE",
         "TFQ_PAIRS_RESIDENT", "TFQ_OZ_HOST_SLICE", "TFQ_PAIRS_TSTEP")


@pytest.fixture(scope="module", autouse=True)
def _x64():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TFQ_OZ_HOST_SLICE", "0")


def _bits(v) -> np.ndarray:
    """The raw bits of a torch tensor or an array, as unsigned integers."""
    if torch.is_tensor(v):
        v = v.contiguous()
        if v.dtype == torch.bfloat16:
            v = v.view(torch.int16)
        v = v.numpy()
    v = np.asarray(v)
    return v.view(np.dtype(f"u{v.dtype.itemsize}"))


def _same_bits(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g, w), int((g != w).sum())


# ------------------------------------------------------------ the modes

@pytest.mark.parametrize("oz_int8", ["0", "1"])
@pytest.mark.parametrize("ozc_int8", [None, "0", "1", "2", "3"])
@pytest.mark.parametrize("comp", ["0", "1"])
@pytest.mark.parametrize("k", [16, 128, 384, 1008, 1024, 3872, 4000,
                               16000, 70000])
def test_mode_params_and_props_are_jax(monkeypatch, k, comp, ozc_int8,
                                       oz_int8):
    monkeypatch.setenv("TFQ_OZ_COMP", comp)
    monkeypatch.setenv("TFQ_OZ_INT8", oz_int8)
    if ozc_int8 is not None:
        monkeypatch.setenv("TFQ_OZC_INT8", ozc_int8)

    def call(mod, int8):
        try:
            tag = mod.oz_mode_params(k, int8=int8)
        except ValueError as e:
            return "ValueError", str(e)
        return tag, mod.precision_props(tag[0])

    for int8 in (None, "0", "2"):
        assert call(tpp, int8) == call(jpp, int8)


# ----------------------------------------------------------- the slicers

def _wide(rng, rows, cols, scale=6.0):
    """float64 data with 10^+-scale row-block scales and zero lanes."""
    v = rng.standard_normal((rows, cols)) * 10.0 ** rng.uniform(
        -scale, scale, (rows // 4, 1)).repeat(4, axis=0)
    v[:, 1] = 0.0
    return v


def _descaled(v, spare: bool):
    """v over its per-lane power-of-two scale (doubled with ``spare``)."""
    tau = tozaki.pow2_scale(torch.from_numpy(np.abs(v).max(axis=0)))
    return v / (tau.numpy() * (2.0 if spare else 1.0))


@pytest.mark.parametrize("p,q", [(7, 8), (8, 7), (9, 6), (11, 5)])
def test_oz_slices_are_jax_bits(p, q):
    pure = _descaled(_wide(np.random.default_rng(p), 64, 12), False)
    got = tpp._oz_slices(torch.from_numpy(pure), p, q)
    want = jpp._oz_slices(jnp.asarray(pure), p, q)
    assert len(got) == len(want) == p
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _same_bits(g, w)


@pytest.mark.parametrize("p,q,r_cap", [(8, 7, 0), (8, 7, -1), (9, 6, 0),
                                       (11, 5, 0)])
def test_oz_slices_int8_are_jax_bits(p, q, r_cap):
    pure = _descaled(_wide(np.random.default_rng(q), 64, 12), r_cap < 0)
    got = tpp._oz_slices_int8(torch.from_numpy(pure), p, q, r_cap_log2=r_cap)
    want = jpp._oz_slices_int8(jnp.asarray(pure), p, q, r_cap_log2=r_cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        _same_bits(g, w)
    for mod in (tpp, jpp):               # q = 8 ints reach 128
        with pytest.raises(ValueError, match="overflows int8"):
            mod._oz_slices_int8(pure, 7, 8)


@pytest.mark.parametrize("p,q,out_int8", [(7, 8, False), (8, 7, False),
                                          (8, 7, True)])
def test_oz_slices_f32pair_are_jax_bits(p, q, out_int8):
    r = _descaled(_wide(np.random.default_rng(p + q), 64, 12), True)
    hi = r.astype(np.float32)
    lo = (r - hi.astype(np.float64)).astype(np.float32)
    got = tpp._oz_slices_f32pair(torch.from_numpy(hi), torch.from_numpy(lo),
                                 p, q, out_int8=out_int8)
    want = jpp._oz_slices_f32pair(jnp.asarray(hi), jnp.asarray(lo), p, q,
                                  out_int8=out_int8)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if out_int8 else torch.bfloat16)
        _same_bits(g, w)


@pytest.mark.parametrize("mode", ["ozc", "xi8", "oz"])
def test_x_prologue_is_jax_bits_on_extreme_lanes(monkeypatch, mode):
    """Lanes below float32's subnormals and above its maximum take the JAX
    prologue's float64 branch, the others its float32 one; the port's one
    float64 prologue gives the same slices and scales for both."""
    lm = 32 if mode == "xi8" else 16
    if mode == "xi8":
        monkeypatch.setenv("TFQ_OZC_INT8", "2")
    if mode == "oz":
        monkeypatch.setenv("TFQ_OZ_COMP", "0")
    rng = np.random.default_rng(7)
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=4, ncols=2, lm=lm, ln=lm)
    a = rng.standard_normal((na, lm, lm)) + 1j * rng.standard_normal(
        (na, lm, lm))
    x = (rng.standard_normal((nx, lm, lm))
         + 1j * rng.standard_normal((nx, lm, lm))) * 10.0 ** rng.uniform(
             -6, 6, (nx, 1, 1))
    x[:, :, 0::4] *= 1e-60
    x[:, :, 1::4] *= 1e60
    x[:, :, 2] = 0.0
    jplan = jpp.pack_pair_plan(pa, px, py, nx, nx, lm, lm, r_tile=1)
    tplan = tpp.pack_pair_plan(pa, px, py, nx, nx, lm, lm, r_tile=1)
    jm = jpp.make_pairpanel_multiply_oz(jplan, a.real, a.imag,
                                        interpret=True)
    slicer = "_oz_slices" if mode == "oz" else "_oz_slices_f32pair"
    seen = []
    real = getattr(jpp, slicer)

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(jpp, slicer, spy)
    jm(jnp.asarray(jpp.permute_x(jplan, x.real, x.imag)))
    tm = tpp.make_pairpanel_multiply_oz(tplan, torch.from_numpy(a.real),
                                        torch.from_numpy(a.imag))
    assert tm.body == mode
    xw, _ = tm.slice_x(torch.from_numpy(tpp.permute_x(tplan, x.real, x.imag)))
    rows = tplan.n_slots * lm
    _same_bits(xw, np.concatenate([np.asarray(s) for s in seen[-1]],
                                  axis=1)[:rows])


# ------------------------------------------- the kernel body and product

BODIES = {                   # id: (knobs, LM, the body, A int8)
    "ozc-bf16": ({}, 16, "ozc", False),
    "ozc-int8a": ({"TFQ_OZC_INT8": "1"}, 16, "ozc", True),
    "ozc-mixed": ({"TFQ_OZC_INT8": "2"}, 16, "ozc", True),
    "xi8": ({"TFQ_OZC_INT8": "2"}, 32, "xi8", True),
    "oz-int8a": ({"TFQ_OZ_COMP": "0"}, 16, "oz", True),
    "oz-bf16": ({"TFQ_OZ_COMP": "0", "TFQ_OZ_INT8": "0"}, 16, "oz", False),
}
LAYOUTS = {"r1": (1, 1), "r2": (2, 1), "g2": (1, 2)}


@functools.lru_cache(maxsize=None)
def _body_case(body: str, layout: str) -> dict:
    """One multiply through the JAX package (interpret mode, its kernel
    output captured) and through the port's plain body, on wide-exponent
    data."""
    env, lm, _, _ = BODIES[body]
    r_tile, group = LAYOUTS[layout]
    rng = np.random.default_rng(zlib.crc32(f"{body}/{layout}".encode()))
    mb = 6 if lm == 32 else 8
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=mb, ncols=2, lm=lm, ln=lm)
    a = (rng.standard_normal((na, lm, lm))
         + 1j * rng.standard_normal((na, lm, lm))) * 10.0 ** rng.uniform(
             -6, 6, (na, 1, 1))
    x = (rng.standard_normal((nx, lm, lm))
         + 1j * rng.standard_normal((nx, lm, lm))) * 10.0 ** rng.uniform(
             -6, 6, (nx, 1, 1))
    want = _np_pairwalk(pa, px, py, a, x, nx)
    out = {"want": want}
    for mod in (jpp, tpp):
        gp, lists = None, (pa, px, py, nx, nx, lm, lm)
        kw = {}
        if group > 1:
            gp = mod.pack_grouped(pa, px, py, nx, lm, group)
            lists = (gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2,
                     lm, gp.ln2)
            kw = dict(row_of=gp.row_of2, col_of=gp.col_of2)
        plan = mod.pack_pair_plan(*lists, r_tile=r_tile, **kw)
        xr, xi = x.real, x.imag
        if gp is not None:
            xr, xi = mod.grouped_blocks(gp, xr), mod.grouped_blocks(gp, xi)
        xf = mod.permute_x(plan, np.asarray(xr), np.asarray(xi))
        with environment({**env, "TFQ_OZ_HOST_SLICE": "0"}):
            if mod is jpp:
                m = jpp.make_pairpanel_multiply_oz(plan, a.real, a.imag,
                                                   interpret=True)
                raw = []
                call = m._call
                m._call = lambda *args: raw.append(call(*args)) or raw[-1]
                y = np.asarray(m(jnp.asarray(xf)))
                out["jax"] = dict(m=m, raw=np.asarray(raw[0]), y=y,
                                  plan=plan)
            else:
                m = tpp.make_pairpanel_multiply_oz(
                    plan, torch.from_numpy(a.real), torch.from_numpy(a.imag))
                xt = torch.from_numpy(xf)
                xw, tau = m.slice_x(xt)
                out["port"] = dict(m=m, raw=m.body_out(xw), y=m(xt),
                                   plan=plan, gp=gp)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("body", list(BODIES))
def test_plain_body_output_is_jax_kernel_bits(body, layout):
    case = _body_case(body, layout)
    jm, tm = case["jax"]["m"], case["port"]["m"]
    _, _, kind, a_int8 = BODIES[body]
    assert (tm.body, tm.a_int8) == (kind, a_int8)
    assert (tm.p, tm.q, tm.comp, tm.xi8) == (jm.p, jm.q, jm.comp, jm.xi8)
    _same_bits(tm.planes, case["jax"]["m"].consts[3])
    _same_bits(tm.sigma, case["jax"]["m"].consts[4])
    raw = case["port"]["raw"]
    assert raw.shape == tm.raw_shape and raw.dtype == torch.float32
    _same_bits(raw, case["jax"]["raw"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("body", list(BODIES))
def test_combined_product_is_jax_bits_and_float64(body, layout):
    case = _body_case(body, layout)
    port = case["port"]
    y = port["y"]
    assert y.dtype == torch.float64
    _same_bits(y, case["jax"]["y"][:y.shape[0]])
    plan, gp = port["plan"], port["gp"]
    yre, yim = tpp.unpermute_y(plan, y.numpy())
    if gp is not None:
        yre, yim = tpp.ungroup_blocks(gp, yre), tpp.ungroup_blocks(gp, yim)
    want = case["want"]
    dev = np.max(np.abs(yre + 1j * yim - want)) / np.abs(want).max()
    assert dev < 1e-12, dev


def _row_major_slices(m, x: torch.Tensor) -> tuple:
    """The X prologue as the port first wrote it, on x as it lies: the
    slice planes concatenated row-major [rows, p*2LN'] and tau [1, 2LN']."""
    c, p, q = m.ln, m.p, m.q
    amax = x.abs().amax(dim=0, keepdim=True)
    if m.comp:
        half = torch.maximum(amax[:, :c], amax[:, c:])
        tau = tozaki.pow2_scale(torch.cat([half, half], dim=1)) * 2.0
        r = x / tau
        hi = r.to(torch.float32)
        lo = (r - hi.to(torch.float64)).to(torch.float32)
        xs = tpp._oz_slices_f32pair(hi, lo, p, q, out_int8=m.xi8)
    else:
        tau = tozaki.pow2_scale(amax)
        xs = tpp._oz_slices(x / tau, p, q)
    return torch.cat(xs, dim=1).contiguous(), tau


@pytest.mark.parametrize("body", list(BODIES))
def test_x_slices_lie_lane_major_with_the_row_major_values(body):
    """``slice_x`` stores the X slice planes lane-major (their transpose
    [p*2LN', rows] is contiguous, the layout the kernel reads, so no
    multiply transposes them): the planes and tau hold the row-major
    prologue's values to the bit, the plain body gives the same bits on
    either, and ``plain()`` is the JAX package's multiply to the bit."""
    case = _body_case(body, "g2")
    m, plan = case["port"]["m"], case["port"]["plan"]
    rng = np.random.default_rng(zlib.crc32(body.encode()))
    x = torch.from_numpy(rng.standard_normal(
        (plan.n_slots * plan.lm, 2 * plan.ln)) * 10.0 ** rng.uniform(
            -6, 6, (1, 2 * plan.ln)))
    xw, tau = m.slice_x(x)
    assert xw.t().is_contiguous() and not xw.is_contiguous()
    want, want_tau = _row_major_slices(m, x)
    _same_bits(xw, want)
    _same_bits(tau, want_tau)
    _same_bits(m.body_plain(xw), m.body_plain(want))
    xj = np.zeros((case["jax"]["plan"].x_rows_padded, x.shape[1]))
    xj[:x.shape[0]] = x.numpy()
    want_y = np.asarray(case["jax"]["m"](jnp.asarray(xj)))[:x.shape[0]]
    _same_bits(m.plain(x), want_y)


@pytest.mark.parametrize("lm", [4, 8])
@pytest.mark.parametrize("body", ["ozc-mixed", "oz-int8a"])
def test_short_slots_of_the_x_slices_take_zero_rows(body, lm):
    """At LM 4 and 8 ``slice_x`` pads every slot of the X slice planes with
    zero rows to 16 (``klm``, the kernel's slot) in the copy it makes: the
    first LM rows of each slot hold the row-major prologue's values to the
    bit and the others are zero, the plain body gives the same bits as on
    the unpadded planes, and ``plain()`` is the JAX package's multiply to
    the bit."""
    env = BODIES[body][0]
    rng = np.random.default_rng(zlib.crc32(f"{body}/{lm}".encode()))
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=8, ncols=2, lm=lm, ln=lm)
    a = (rng.standard_normal((na, lm, lm))
         + 1j * rng.standard_normal((na, lm, lm))) * 10.0 ** rng.uniform(
             -6, 6, (na, 1, 1))
    x = (rng.standard_normal((nx, lm, lm))
         + 1j * rng.standard_normal((nx, lm, lm))) * 10.0 ** rng.uniform(
             -6, 6, (nx, 1, 1))
    jplan = jpp.pack_pair_plan(pa, px, py, nx, nx, lm, lm, r_tile=1)
    tplan = tpp.pack_pair_plan(pa, px, py, nx, nx, lm, lm, r_tile=1)
    with environment({**env, "TFQ_OZ_HOST_SLICE": "0"}):
        jm = jpp.make_pairpanel_multiply_oz(jplan, a.real, a.imag,
                                            interpret=True)
        tm = tpp.make_pairpanel_multiply_oz(tplan, torch.from_numpy(a.real),
                                            torch.from_numpy(a.imag))
    assert tm.body == BODIES[body][2] and tm.klm == 16
    xt = torch.from_numpy(tpp.permute_x(tplan, x.real, x.imag))
    xw, tau = tm.slice_x(xt)
    assert xw.shape == (tplan.n_slots * 16, tm.p * 2 * tm.ln)
    assert xw.t().is_contiguous()
    want, want_tau = _row_major_slices(tm, xt)
    slots = xw.reshape(tplan.n_slots, 16, -1)
    _same_bits(slots[:, :lm], want.reshape(tplan.n_slots, lm, -1))
    assert int((slots[:, lm:] != 0).sum()) == 0
    _same_bits(tau, want_tau)
    _same_bits(tm.body_plain(xw), tpp.oz_body_plain(
        tm.planes, want, tm.xloc, tm.m, lm, tm.ln, tm.p, tm.q, tm.body,
        tm.a_int8))
    xj = np.zeros((jplan.x_rows_padded, xt.shape[1]))
    xj[:xt.shape[0]] = xt.numpy()
    want_y = np.asarray(jm(jnp.asarray(xj)))[:xt.shape[0]]
    _same_bits(tm.plain(xt), want_y)


def test_plain_multiply_is_the_wrapper_on_the_cpu():
    port = _body_case("xi8", "r1")["port"]
    m, plan = port["m"], port["plan"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (plan.n_slots * plan.lm, 2 * plan.ln)))
    before = tpp.OzPairPanelMultiply.launches
    assert torch.equal(m(x), m.plain(x))
    assert tpp.OzPairPanelMultiply.launches == before
    with pytest.raises(ValueError, match="float64"):
        m(x.float())


# ------------------------------------------------------ float64 vectors

@pytest.mark.parametrize("group", [1, 2])
def test_fused_primitives_float64_reductions(group):
    rng = np.random.default_rng(11 + group)
    lm = ln = 4
    pa, px, py, na, nx = _bsr_pair_plan(rng, mb=10, ncols=4, lm=lm, ln=ln)
    prims = {}
    # X is full over 4 block columns: block i sits in row i // 4, column i % 4
    geometry = dict(row_of=np.arange(nx) // 4, col_of=np.arange(nx) % 4)
    for mod in (jpp, tpp):
        gp, lists, kw = None, (pa, px, py, nx, nx, lm, ln), geometry
        if group > 1:
            gp = mod.pack_grouped(pa, px, py, nx, ln, group, **geometry)
            lists = (gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2,
                     lm, gp.ln2)
            kw = dict(row_of=gp.row_of2, col_of=gp.col_of2)
        prims[mod] = (mod.pack_pair_plan(*lists, r_tile=1, **kw), gp)
    tplan, tgp = prims[tpp]
    jplan, jgp = prims[jpp]
    rows = tplan.n_slots * lm
    x, y = (rng.standard_normal((rows, 2 * tplan.ln)) * 10.0 ** rng.uniform(
        -3, 3, (rows // lm, 1)).repeat(lm, 0) for _ in range(2))
    if tgp is not None:                  # absent lanes hold zeros
        mask = tpp.grouped_lane_mask(tplan, tgp).repeat(lm, axis=0)[:rows]
        x, y = x * mask, y * mask
    ncc = 4

    def pad(v):
        return jnp.asarray(np.pad(v, ((0, jplan.x_rows_padded - rows),
                                      (0, 0))))

    jp = jpp.fused_primitives(None, None, jplan, ncc, pad(y), jgp)
    tp = tpp.fused_primitives(None, tplan, ncc, torch.from_numpy(y), tgp)
    got_d = [t.numpy() for t in tp.dotp(torch.from_numpy(x),
                                        torch.from_numpy(y))]
    want_d = [np.asarray(t) for t in jp.dotp(pad(x), pad(y))]
    got_n = tp.nrm2(torch.from_numpy(x)).numpy()
    want_n = np.asarray(jp.nrm2(pad(x)))
    assert got_n.dtype == got_d[0].dtype == np.float64
    # the float64 sums of the same columns
    xf = tpp.unpermute_y(tplan, x)
    yf = tpp.unpermute_y(tplan, y)
    if tgp is not None:
        xf = [tpp.ungroup_blocks(tgp, v) for v in xf]
        yf = [tpp.ungroup_blocks(tgp, v) for v in yf]
    xc, yc = xf[0] + 1j * xf[1], yf[0] + 1j * yf[1]
    for v, w in ((got_d[0], want_d[0]), (got_d[1], want_d[1]),
                 (got_n, want_n)):
        assert v.shape == w.shape == (ncc, ln)
        assert np.max(np.abs(v - w)) <= 1e-14 * np.max(np.abs(w))
    cols = geometry["col_of"]
    d = np.zeros((ncc, ln), complex)
    n = np.zeros((ncc, ln))
    np.add.at(d, cols, (xc * yc).sum(axis=1))
    np.add.at(n, cols, (np.abs(xc) ** 2).sum(axis=1))
    for v, w in ((got_d[0], d.real), (got_d[1], d.imag), (got_n, n)):
        assert np.max(np.abs(v - w)) <= 1e-14 * np.max(np.abs(w))


# ----------------------------------------------------------- the solves

# id: (LM, TFQ_SOLVER_SUPER, TFQ_PAIRS_COLGROUP, G of the pack, body); the
# merged case's G is the superblock's lane widening toward 32 lanes
Z_SOLVES = {
    "lm16": (16, "0", "1", 1, "ozc"),
    "lm8-merged": (8, "2", "1", 2, "ozc"),
    "lm32-xi8": (32, "0", "2", 2, "xi8"),
}


@pytest.mark.parametrize("case", list(Z_SOLVES))
def test_packed_z_solve_is_jax(monkeypatch, case):
    lm, sup, pin, group, body = Z_SOLVES[case]
    # t_step 1: the JAX kernel computes the same at any t_step, and its
    # interpret-mode compile grows with it
    for k, v in (("TFQ_PAIRS_Z_OZ", "1"), ("TFQ_SOLVER_SUPER", sup),
                 ("TFQ_PAIRS_COLGROUP", pin), ("TFQ_PAIRS_TSTEP", "1")):
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(lm + group)
    a, x, b = make_random_problem(rng, mb=6 if lm == 32 else 8, lm=lm,
                                  ln=lm, ncols=2, x_fill=0.7,
                                  dtype=np.complex128)
    js = jsolver.Solver(a, x, b, precision="z", engine="pairs")
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, lm, lm)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="z", engine="pairs", plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    # the same pack decisions
    assert ts.engine == js.engine == "pairs"
    for s in (js, ts):
        assert (s._gp.group_size if s._gp is not None else 1) == group
    assert ((ts._sup.f_row if ts._sup else 0)
            == (js._sup.f_row if js._sup else 0) == int(sup))
    assert ts._pp_plan.lm == js._pp_plan.lm == max(lm, 16)
    assert ts._pp_plan.ku == js._pp_plan.ku
    assert ts._pp_plan.ntiles == js._pp_plan.ntiles
    m = ts._multiply
    assert isinstance(m, tpp.OzPairPanelMultiply) and m.body == body
    assert (m.p, m.q, m.comp, m.xi8) == (js._pp.p, js._pp.q, js._pp.comp,
                                         js._pp.xi8)
    infos = [s.solve(tolerance=1e-10, max_iterations=300) for s in (js, ts)]
    jinfo, tinfo = infos
    assert tinfo.engine == "pairs"
    assert tinfo.return_status == jinfo.return_status == Status.SUCCESS
    assert tinfo.iterations_needed == jinfo.iterations_needed
    assert np.array_equal(np.asarray(tinfo.rhs_status),
                          np.asarray(jinfo.rhs_status))
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    assert got.dtype == np.complex128
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_z_pairs_stays_on_k1_without_the_knob():
    rng = np.random.default_rng(5)
    a, x, b = make_random_problem(rng, mb=8, lm=16, ln=16, ncols=2,
                                  dtype=np.complex128)
    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    assert isinstance(s._multiply, tpp.PairPlanMultiply)
    assert not s._packed and s._pp_plan is None


def test_z_oz_below_lm16_refuses_or_goes_to_xla(monkeypatch):
    """The JAX solver's rule: the Ozaki kernel needs a kernel LM >= 16; an
    explicit 'pairs' raises PRECISION_MISSMATCH, 'auto' takes 'xla'."""
    monkeypatch.setenv("TFQ_PAIRS_Z_OZ", "1")
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "0")
    rng = np.random.default_rng(6)
    a, x, b = make_random_problem(rng, mb=8, lm=8, ln=8, ncols=2,
                                  dtype=np.complex128)
    with pytest.raises(TfqmrgpuError) as e:
        tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    assert e.value.code == Status.PRECISION_MISSMATCH
    a, x, b = make_random_problem(rng, mb=24, lm=8, ln=8, ncols=2,
                                  dtype=np.complex128)
    monkeypatch.setattr(tsolver, "DENSE_A_BYTE_LIMIT", 0)
    s = tt.Solver(*_port(a, x, b), precision="z", engine="auto",
                  device="cpu")
    assert s.engine == "xla" and not s._packed


def _fd_solvers(f_row: str):
    """FD rtb=12.75 'z' 'pairs' under TFQ_PAIRS_Z_OZ=1 at TFQ_SOLVER_SUPER
    ``f_row`` in both packages, the JAX plan and v3 handed to the port (on
    the CPU): (JAX Solver, port Solver, (A, X, B))."""
    from tfqmrgpu_tpu.generator import generate_fd_problem

    fd = generate_fd_problem(rtb=12.75, reference=False)
    a, x, b = fd.a_with_data(), fd.x, fd.b_with_data()
    js = jsolver.Solver(a, x, b, precision="z", engine="pairs")
    jp = js.plan
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    v3 = jcore.make_shadow_vector(jp.nnzb_x, js.lm, js.ln)
    ts = tt.Solver(*_port(a, x, b), precision="z", engine="pairs", plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    return js, ts, (a, x, b)


# TFQ_SOLVER_SUPER: (LM', body, int8 A) of FD's merged pack
FD_PACKS = {"2": (16, "ozc", True), "4": (32, "xi8", True)}


@pytest.mark.parametrize("f_row", list(FD_PACKS))
def test_fd_merged_multiply_is_jax_bits(monkeypatch, f_row):
    """FD rtb=12.75 'z' under TFQ_PAIRS_Z_OZ=1 at f 2 (LM' 16, the mixed
    body) and f 4 (LM' 32, 'xi8'): the port's multiply on the merged plan
    equals the JAX package's to the bit.  The route stagnates above 1e-9
    on FD in both packages (``python tests/test_torch_oz_pairs.py fd``,
    chip_smoke.py phase 21 (d)); this holds that the port computes what
    the JAX route computes."""
    for k, v in (("TFQ_PAIRS_Z_OZ", "1"), ("TFQ_SOLVER_SUPER", f_row),
                 ("TFQ_PAIRS_TSTEP", "1")):
        monkeypatch.setenv(k, v)
    js, ts, _ = _fd_solvers(f_row)
    lm, body, a_int8 = FD_PACKS[f_row]
    assert ts._sup.f_row == js._sup.f_row == int(f_row)
    assert (ts._pp_plan.lm, ts._pp_plan.ku, ts._pp_plan.ntiles) == (
        js._pp_plan.lm, js._pp_plan.ku, js._pp_plan.ntiles)
    assert ts._pp_plan.lm == lm
    assert (ts._multiply.body, ts._multiply.a_int8) == (body, a_int8)
    assert (ts._multiply.p, ts._multiply.q, ts._multiply.xi8) == (
        js._pp.p, js._pp.q, js._pp.xi8)
    rows = ts._pp_plan.n_slots * ts._pp_plan.lm
    xt = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (rows, 2 * ts._pp_plan.ln))) * ts._sup_mask
    xj = np.zeros((js._pp_plan.x_rows_padded, 2 * js._pp_plan.ln))
    xj[:rows] = xt.numpy()
    want = np.asarray(js._pp.apply(js._pp.consts, jnp.asarray(xj)))[:rows]
    _same_bits(ts._multiply(xt), want)


def fd_stagnation_readings(f_row: str, cap: int = 300) -> dict:
    """FD rtb=12.75 'z' 'pairs' under TFQ_PAIRS_Z_OZ=1 at TFQ_SOLVER_SUPER
    ``f_row``, solved to 1e-9 with at most ``cap`` iterations by the JAX
    package (its kernel in interpret mode) and by the port on the CPU with
    JAX's plan and v3, beside the port's native 'z' (K1's plain version)
    at the same tolerance: status, iterations, residuum reached, and X's
    largest deviation from the native solve, relative to its largest
    entry.  A reading, not a test: the JAX solve takes about 1.7 s a
    multiply on an 8-core CPU, 15-50 minutes at the cap."""
    import os
    import time

    saved = {k: os.environ.get(k) for k in KNOBS}
    os.environ.update(TFQ_PAIRS_Z_OZ="1", TFQ_SOLVER_SUPER=f_row,
                      TFQ_PAIRS_TSTEP="1", TFQ_OZ_HOST_SLICE="0")
    try:
        js, ts, (a, x, b) = _fd_solvers(f_row)
        for k in ("TFQ_PAIRS_Z_OZ", "TFQ_SOLVER_SUPER"):
            del os.environ[k]
        native = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                           device="cpu")
        ninfo = native.solve(tolerance=1e-9, max_iterations=cap)
        xn = native.get_matrix("X")
        out = {"f_row": int(f_row), "lm": ts._pp_plan.lm,
               "body": ts._multiply.body, "native": {
                   "status": int(ninfo.return_status),
                   "iterations": ninfo.iterations_needed,
                   "residuum": float(ninfo.residuum_reached)}}
        for name, s in (("jax", js), ("port", ts)):
            t0 = time.perf_counter()
            info = s.solve(tolerance=1e-9, max_iterations=cap)
            xs = np.asarray(s.get_matrix("X"))
            out[name] = {
                "status": int(info.return_status),
                "iterations": info.iterations_needed,
                "residuum": float(info.residuum_reached),
                "x_from_native": float(np.max(np.abs(xs - xn))
                                       / np.max(np.abs(xn))),
                "seconds": time.perf_counter() - t0}
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_oz_pairs.py
    #     fd F_ROW [CAP]
    import json
    import sys

    jax.config.update("jax_enable_x64", True)
    if sys.argv[1:2] != ["fd"] or len(sys.argv) not in (3, 4):
        sys.exit("usage: test_torch_oz_pairs.py fd F_ROW [CAP]")
    print(json.dumps(fd_stagnation_readings(
        sys.argv[2], *(int(v) for v in sys.argv[3:]))))

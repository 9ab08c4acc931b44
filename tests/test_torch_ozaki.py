"""The port's ``ops/ozaki.py`` and its two opt-in callers against the JAX
package's on the CPU.

* ``slice_params`` and ``slice_params_comp`` equal JAX's for k in 1..4096
  and raise where JAX's raise;
* ``pow2_scale`` is JAX's to the bit, zeros included and |log2 amax| up to
  326; ``slice_operand``'s slices and scales are JAX's to the bit;
* ``matmul_oz`` and ``matmul_oz_complex`` within 1e-14 of JAX's, relative
  to the row and column scales (float64 sums of the same exact products in
  another order), and within their truncation floor of the float64
  product;
* the 'xla' ('TFQ_XLA_OZ=1') and 'dense' ('TFQ_Z_OZAKI=1') 'z' solves in
  both packages, the JAX plan and v3 handed over: equal iterations and X
  within 1e-12.  The port's default for both knobs is '0' (native
  float64), the JAX package's '1'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfqmrgpu_tpu_torch as tt
from conftest import make_random_problem
from test_torch_panel import _port
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.ops import ozaki as jo
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import blocksparse, ozaki, panel

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield


def test_slice_params_equal_jax():
    for k in range(1, 4097):
        for diag in (False, True):
            assert ozaki.slice_params(k, diag_sum=diag) == jo.slice_params(
                k, diag_sum=diag), (k, diag)
        assert ozaki.slice_params_comp(k) == jo.slice_params_comp(k), k
        assert ozaki.slice_params(k, bits=64) == jo.slice_params(k, bits=64)
    # the JAX package's own points (tests/test_ozaki.py:18-39)
    assert ozaki.slice_params(448) == (8, 7)
    assert ozaki.slice_params(4096)[1] == 6
    assert ozaki.slice_params_comp(448) == (7, 8)
    assert ozaki.slice_params_comp(1008) == (7, 8)
    assert ozaki.slice_params_comp(1009) == (8, 7)
    for fn, k in ((ozaki.slice_params, 2 ** 22),
                  (ozaki.slice_params_comp, 2 ** 24),
                  (ozaki.slice_params, 0), (ozaki.slice_params_comp, 0)):
        with pytest.raises(ValueError):
            fn(k)
    for p in range(1, 10):
        for t, j in zip(ozaki.slice_pairs(p), jo.slice_pairs(p)):
            assert t.dtype == j.dtype and np.array_equal(t, j)


def test_pow2_scale_bit_identical():
    rng = np.random.default_rng(0)
    e = np.concatenate([np.arange(-326, 327), rng.uniform(-326, 326, 2000)])
    amax = np.concatenate([
        2.0 ** e * rng.uniform(0.5, 1.0, e.size), 2.0 ** np.arange(-326, 327),
        [0.0, 0.0, 1.0, 2.0 ** 126, 2.0 ** -125, np.nextafter(2.0 ** 126, 0),
         np.nextafter(2.0 ** -125, 1), 2.0 ** -1074, 1.7e308]])
    got = ozaki.pow2_scale(torch.from_numpy(amax)).numpy()
    want = np.asarray(jo.pow2_scale(jnp.asarray(amax)))
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    ok = (amax > 0) & (np.abs(np.log2(np.where(amax > 0, amax, 1))) <= 326)
    assert np.all(got[ok] >= amax[ok])                  # never below amax


@pytest.mark.parametrize("spare", [False, True])
def test_slice_operand_bit_identical(spare):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((64, 37)) * 10.0 ** rng.uniform(-8, 8, (64, 37))
    v[5] = 0.0                                          # a zero row
    for axis, (p, q) in ((0, (8, 7)), (1, (7, 8))):
        ts, tsc = ozaki.slice_operand(torch.from_numpy(v), axis=axis, p=p,
                                      q=q, spare_binade=spare)
        js, jsc = jo.slice_operand(jnp.asarray(v), axis=axis, p=p, q=q,
                                   spare_binade=spare)
        assert ts.dtype == torch.bfloat16 and tuple(ts.shape) == js.shape
        assert np.array_equal(ts.view(torch.int16).numpy(),
                              np.asarray(js).view(np.int16))
        assert np.array_equal(tsc.numpy(), np.asarray(jsc))


def _scales(a, x):
    return np.abs(a).max(axis=1)[:, None] * np.abs(x).max(axis=0)[None]


@pytest.mark.parametrize("m,k,n", [(40, 300, 20), (16, 1009, 8)])
def test_matmul_oz_matches_jax(m, k, n):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)) * 10.0 ** rng.uniform(-3, 3, (m, 1))
    x = rng.standard_normal((k, n))
    got = ozaki.matmul_oz(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    want = np.asarray(jo.matmul_oz(a, x))
    sc = _scales(a, x)
    assert np.max(np.abs(got - want) / sc) <= 1e-14
    assert np.max(np.abs(got - a @ x) / sc) <= k * 2.0 ** -52
    with pytest.raises(TypeError, match="float64"):
        ozaki.matmul_oz(torch.from_numpy(a.astype(np.float32)),
                        torch.from_numpy(x))


def test_matmul_oz_complex_matches_jax():
    rng = np.random.default_rng(7)
    ar, ai = rng.standard_normal((2, 40, 300))      # the shapes above: one
    xr, xi = rng.standard_normal((2, 300, 20))      # compile of JAX's product
    got = ozaki.matmul_oz_complex(*(torch.from_numpy(v)
                                    for v in (ar, ai, xr, xi)))
    want = jo.matmul_oz_complex(ar, ai, xr, xi)
    sc = 2 * _scales(np.maximum(np.abs(ar), np.abs(ai)),
                     np.maximum(np.abs(xr), np.abs(xi)))
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w)) / sc) <= 1e-14


def test_knobs_default_to_native_float64(monkeypatch):
    """Without the knobs the port's 'z' engines run plain float64."""
    monkeypatch.delenv("TFQ_XLA_OZ", raising=False)
    monkeypatch.delenv("TFQ_Z_OZAKI", raising=False)
    a, x, b = _port(*make_random_problem(np.random.default_rng(8), mb=8,
                                         lm=4, ln=4, ncols=2))
    s = tt.Solver(a, x, b, precision="z", engine="xla", device="cpu")
    assert isinstance(s._multiply, blocksparse.BlockSparseAction)
    assert s._multiply.oz_pq is None
    monkeypatch.setenv("TFQ_XLA_OZ", "1")
    s = tt.Solver(a, x, b, precision="z", engine="xla", device="cpu")
    assert s._multiply.oz_pq == jo.slice_params(4)


def test_dense_oz_falls_back_where_too_deep(monkeypatch):
    """JAX's fallback: a depth slice_params_comp refuses runs the plain
    float64 product."""
    monkeypatch.setenv("TFQ_Z_OZAKI", "1")
    calls = []
    real = ozaki.slice_params_comp

    def refuse(k, bits=53):
        calls.append(k)
        raise ValueError("too deep")

    monkeypatch.setattr(ozaki, "slice_params_comp", refuse)
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((8, 8)))
    mask4 = torch.ones((2, 1, 1, 1), dtype=torch.float64)
    mult = panel.dense_multiply(a, a, mask4, 2, 4, 1, 3)
    x = torch.from_numpy(rng.standard_normal((8, 1, 3)))
    y = mult((x, x))
    assert calls == [8]
    want = (a @ x.reshape(8, 3) - a @ x.reshape(8, 3)).reshape(8, 1, 3)
    assert torch.equal(y[0], want)
    monkeypatch.setattr(ozaki, "slice_params_comp", real)
    oz = panel.dense_multiply(a, a, mask4, 2, 4, 1, 3)((x, x))
    sc = float(a.abs().max() * x.abs().max()) * 8
    assert float((oz[1] - 2 * (a @ x.reshape(8, 3)).reshape(8, 1, 3)).abs()
                 .max()) <= 1e-14 * sc


@pytest.mark.parametrize("engine,knob,lm", [("xla", "TFQ_XLA_OZ", 8),
                                            ("dense", "TFQ_Z_OZAKI", 4)])
def test_oz_solve_matches_jax(monkeypatch, engine, knob, lm):
    monkeypatch.setenv(knob, "1")
    a, x, b = make_random_problem(np.random.default_rng(10 + lm), mb=10,
                                  lm=lm, ln=lm, ncols=3)
    js = jsolver.Solver(a, x, b, precision="z", engine=engine)
    jinfo = js.solve(tolerance=1e-10, max_iterations=200)
    jp = js.plan
    v3 = jcore.make_shadow_vector(jp.nnzb_x, lm, lm)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision="z", engine=engine, plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    if engine == "xla":
        assert ts._multiply.oz_pq is not None
    tinfo = ts.solve(tolerance=1e-10, max_iterations=200)
    assert tinfo.return_status == jinfo.return_status == Status.SUCCESS
    assert tinfo.iterations_needed == jinfo.iterations_needed
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    # the slices do not move the native solve's answer either
    monkeypatch.setenv(knob, "0")
    ns = tt.Solver(*_port(a, x, b), precision="z", engine=engine, plan=plan,
                   v3=tuple(np.asarray(v) for v in v3), device="cpu")
    ninfo = ns.solve(tolerance=1e-10, max_iterations=200)
    assert ninfo.iterations_needed == tinfo.iterations_needed
    assert np.max(np.abs(ns.get_matrix("X") - got)) <= 1e-12 * np.max(
        np.abs(got))

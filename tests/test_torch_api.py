"""The port's C-API-parity layer (``tfqmrgpu_tpu_torch.api``) against the
JAX package's ``tfqmrgpu_tpu.api`` on the CPU.

* The ten-step workflow in 'z' and 'c': bit-identical plan tables, equal
  ``bufferSize``, the same status and iterations, and X within 1e-12 ('z')
  and 1e-4 ('c') relative, with JAX's v3 handed to the port.  The JAX side
  runs its float64 products in plain float64 (TFQ_XLA_OZ=0, TFQ_Z_OZAKI=0).
* Every error path and introspection call of tests/test_api.py gives the
  same packed code in both packages.
* 'm' through the plan API reaches the 'z' gate (a dense float64 residual
  over X's pattern below 1e-8) and getMatrix returns the refined X.
* ``Bsr.pattern_key`` / ``from_scipy_bsr`` / ``to_scipy_bsr``,
  ``Plan.memory_requirement_bytes`` and the pattern cache of
  ``create_plan``.
* Without a card, a default handle and a one-call solve give
  NO_IMPLEMENTATION and run nothing on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

from tfqmrgpu_tpu import api as japi
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu.bsr import Bsr as JBsr
from tfqmrgpu_tpu.errors import decode_status
from tfqmrgpu_tpu.plan import create_plan as jcreate_plan
from tfqmrgpu_tpu_torch import api as tapi
from tfqmrgpu_tpu_torch import plan as tplan
from tfqmrgpu_tpu_torch.bsr import BlockSparseMatrix, Bsr as TBsr, make_bsr
from tfqmrgpu_tpu_torch.errors import Status, TfqmrgpuError
from tfqmrgpu_tpu_torch.ops.layout import LAYOUT_RIRIRIRI
from conftest import dense_from_bsr, make_random_problem

torch.set_num_threads(2)

RTOL = {"z": 1e-12, "c": 1e-4}


def _riri(c, dtype=np.float64):
    """Complex [nnzb, d1, d2] -> the C host layout RIRIRIRI."""
    return np.ascontiguousarray(np.stack([c.real, c.imag], axis=-1),
                                dtype=dtype)


def _complex(riri):
    return riri[..., 0] + 1j * riri[..., 1]


def _pattern_residual(a, x, b, xc, lm, ln):
    """|A X - B| / |B| over X's pattern, where tfQMR solves the system."""
    mask = dense_from_bsr(x.with_data(np.ones((x.nnzb, lm, ln))), lm, ln) != 0
    r = dense_from_bsr(a, lm, lm) @ dense_from_bsr(x.with_data(xc), lm, ln) \
        - dense_from_bsr(b, lm, ln)
    return np.linalg.norm(r[mask]) / np.linalg.norm(dense_from_bsr(b, lm, ln))


@pytest.fixture
def plain_jax(monkeypatch):
    """The JAX package's float64 products in plain float64."""
    monkeypatch.setenv("TFQ_XLA_OZ", "0")
    monkeypatch.setenv("TFQ_Z_OZAKI", "0")


def _ten_steps(api, handle, a, x, b, precision, lm, ln, v3=None):
    """createPlan ... getMatrix through ``api`` on ``handle``; returns
    (plan state, bufferSize, solve status, getInfo, X)."""
    dt = np.float32 if precision == "c" else np.float64
    st, p = api.bsrsv_create_plan(handle, a.nrows, a.rowptr, a.colind,
                                  x.rowptr, x.colind, b.rowptr, b.colind)
    assert st == 0
    st, nbytes = api.bsrsv_buffer_size(handle, p, lm, lm, ln, ln, precision)
    assert st == 0
    st, ws = api.create_workspace(nbytes)
    assert api.bsrsv_set_buffer(handle, p, ws) == 0
    if v3 is not None:
        api._PLANS[p].solver.set_shadow_vector(*v3)
    assert api.bsrsv_set_matrix(handle, p, "A", _riri(a.data, dt), precision,
                                lm, lm, "n", LAYOUT_RIRIRIRI) == 0
    assert api.bsrsv_set_matrix(handle, p, "B", _riri(b.data, dt), precision,
                                lm, ln, "n", LAYOUT_RIRIRIRI) == 0
    tol = 1e-10 if precision == "z" else 1e-5
    solve_st = api.bsrsv_solve(handle, p, tol, 300)
    info = api.bsrsv_get_info(handle, p)
    st, xval = api.bsrsv_get_matrix(handle, p, "X", precision, lm, ln, "n",
                                    LAYOUT_RIRIRIRI)
    assert st == 0
    ps = api._PLANS[p]
    assert api.bsrsv_destroy_plan(handle, p) == 0
    assert api.destroy_workspace(ws) == 0
    return ps, nbytes, solve_st, info, _complex(xval)


@pytest.mark.parametrize("precision", ["z", "c"])
def test_ten_step_workflow_matches_jax(rng, plain_jax, precision):
    lm, ln = 4, 8
    dtype = np.complex64 if precision == "c" else np.complex128
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                  x_fill=0.7, dtype=dtype)
    st, jh = japi.create_handle()
    st, th = tapi.create_handle(device="cpu")
    assert st == 0 and tapi._HANDLES[th].device == torch.device("cpu")
    jps, jbytes, jst, jinfo, jx = _ten_steps(japi, jh, a, x, b, precision,
                                             lm, ln)
    v3 = tuple(np.asarray(v) for v in
               jcore.make_shadow_vector(jps.plan.nnzb_x, lm, ln))
    tps, tbytes, tst, tinfo, tx = _ten_steps(tapi, th, a, x, b, precision,
                                             lm, ln, v3=v3)
    for k in ("starts", "pairs", "subset", "colindx"):
        want = np.asarray(getattr(jps.plan, k)).astype(np.int64)
        got = getattr(tps.plan, k).cpu().numpy().astype(np.int64)
        np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=k)
    assert tps.solver.engine == jps.solver.engine
    assert tbytes == jbytes
    assert (tst, tinfo[0], tinfo[2]) == (jst, jinfo[0], jinfo[2])
    assert tst == 0
    rel = np.max(np.abs(tx - jx)) / np.max(np.abs(jx))
    assert rel <= RTOL[precision], rel
    # the solution, independently: A @ X == B over X's pattern
    assert _pattern_residual(a, x, b, tx, lm, ln) < (
        1e-9 if precision == "z" else 1e-4)
    assert tapi.destroy_handle(th) == 0
    japi.destroy_handle(jh)


def test_set_matrix_before_set_buffer_is_deferred(rng):
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2)
    st, h = tapi.create_handle(device="cpu")
    st, p = tapi.bsrsv_create_plan(h, a.nrows, a.rowptr, a.colind,
                                   x.rowptr, x.colind, b.rowptr, b.colind)
    st, _ = tapi.bsrsv_buffer_size(h, p, lm, lm, ln, ln, "z")
    assert tapi.bsrsv_set_matrix(h, p, "A", _riri(a.data)) == 0
    assert tapi.bsrsv_set_matrix(h, p, "B", _riri(b.data)) == 0
    assert tapi._PLANS[p].pending
    assert tapi.bsrsv_set_buffer(h, p) == 0
    assert not tapi._PLANS[p].pending
    assert tapi.bsrsv_solve(h, p, 1e-8, 200) == 0
    tapi.bsrsv_destroy_plan(h, p)
    tapi.destroy_handle(h)


def _error_codes(api, handle, a, x, b):
    """The packed codes of the error paths of tests/test_api.py and more:
    unknown ids, the call order, bad arguments; in order."""
    lm = 4
    codes = [api.destroy_handle(999999), api.bsrsv_destroy_plan(0, 999999),
             api.bsrsv_get_info(0, 999999)[0],
             api.set_stream(999999, 1), api.get_stream(999999)[0],
             api.destroy_workspace(999999), api.bsrsv_get_buffer(0, 999999)[0],
             api.bsrsv_solve(0, 999999)]
    bad_rowptr_b = np.array([0] + [1] * a.nrows, dtype=np.int32)
    bad_colind_b = np.array([x.ncols + 3], dtype=np.int32)    # not in X
    codes.append(api.bsrsv_create_plan(handle, a.nrows, a.rowptr, a.colind,
                                       x.rowptr, x.colind, bad_rowptr_b,
                                       bad_colind_b))
    st, p = api.bsrsv_create_plan(handle, a.nrows, a.rowptr, a.colind,
                                  x.rowptr, x.colind, b.rowptr, b.colind)
    codes += [api.bsrsv_solve(handle, p),                  # before setBuffer
              api.bsrsv_set_buffer(handle, p),             # before bufferSize
              api.bsrsv_get_matrix(handle, p, "X"),
              api.bsrsv_buffer_size(handle, p, lm, lm, lm, lm, "q"),
              api.bsrsv_buffer_size(handle, p, lm + 1, lm, lm, lm, "z"),
              api.bsrsv_buffer_size(handle, p, 8, 8, 4, 4, "z")]
    assert api.bsrsv_buffer_size(handle, p, lm, lm, lm, lm, "z")[0] == 0
    codes.append(api.bsrsv_set_matrix(handle, p, "A", _riri(a.data), "c"))
    assert api.bsrsv_set_buffer(handle, p) == 0
    codes += [api.bsrsv_get_matrix(handle, p, "X", "c"),
              api.bsrsv_get_matrix(handle, p, "X", "z"),     # before solve
              api.bsrsv_set_matrix(handle, p, "Q", _riri(a.data), "z"),
              api.bsrsv_set_matrix(handle, p, "A", _riri(a.data), "z", 4, 4,
                                   "q")]
    api.bsrsv_destroy_plan(handle, p)
    return codes


def test_error_paths_match_jax(rng):
    a, x, b = make_random_problem(rng, mb=6, lm=4, ln=4, ncols=2)
    st, jh = japi.create_handle()
    st, th = tapi.create_handle(device="cpu")
    jcodes = _error_codes(japi, jh, a, x, b)
    tcodes = _error_codes(tapi, th, a, x, b)
    assert tcodes == jcodes
    assert all(isinstance(c, int) for c in tcodes)
    got = [decode_status(c)[0] for c in tcodes]
    assert got[:9] == [int(Status.POINTER_INVALID)] * 8 + [
        int(Status.B_IS_NOT_SUBSET_OF_X)]
    assert int(Status.NO_INFO_PASSED) in got
    assert int(Status.PRECISION_MISSMATCH) in got
    assert int(Status.TANSPOSITION_UNKNOWN) in got
    japi.destroy_handle(jh)
    tapi.destroy_handle(th)


def test_introspection_matches_jax():
    assert tapi.bsrsv_allowed_block_sizes() == japi.bsrsv_allowed_block_sizes()
    assert tapi.bsrsv_allowed_block_sizes(7) == japi.bsrsv_allowed_block_sizes(7)
    st, n, flat = tapi.bsrsv_allowed_block_sizes()
    assert st == 0 and n == 15 and len(flat) == 30
    for ld in ((32, 32), (3, 7), (4, 5), (64, 64), (8, 7)):
        assert tapi.bsrsv_block_size_missing(*ld) == \
            japi.bsrsv_block_size_missing(*ld)
    assert tapi.bsrsv_block_size_missing(3, 7) == int(Status.BLOCKSIZE_MISSING)
    assert tapi.set_stream(0, 1) == japi.set_stream(0, 1)


def test_handle_streams_and_workspaces():
    st, h = tapi.create_handle(device="cpu")
    assert tapi.set_stream(h, 7) == 0
    assert tapi.get_stream(h) == (0, 7)
    st, tok = tapi.create_workspace(1 << 20)
    assert st == 0 and tok != 0
    assert tapi.destroy_workspace(tok) == 0
    assert tapi.destroy_workspace(tok) == japi.destroy_workspace(10 ** 9)
    assert tapi.destroy_handle(h) == 0


def test_mixed_through_the_plan_api(rng, plain_jax):
    """'m' iterates in 'c', refines against a float64 residual and reaches
    the 'z' gate; getMatrix returns the refined X, in 'z' and 'c'."""
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0)
    st, h = tapi.create_handle(device="cpu")
    st, p = tapi.bsrsv_create_plan(h, a.nrows, a.rowptr, a.colind,
                                   x.rowptr, x.colind, b.rowptr, b.colind)
    st, nbytes = tapi.bsrsv_buffer_size(h, p, lm, lm, ln, ln, "m")
    plan = tapi._PLANS[p].plan
    assert nbytes == plan.memory_requirement_bytes(lm, ln, "z")
    assert tapi.bsrsv_set_buffer(h, p) == 0
    assert tapi._PLANS[p].solver.precision == "c"
    assert tapi.bsrsv_set_matrix(h, p, "A", _riri(a.data), "z") == 0
    assert tapi.bsrsv_set_matrix(h, p, "B", _riri(b.data), "m") == 0
    assert tapi.bsrsv_solve(h, p, 1e-10, 400) == 0
    st, resid, iters, flops, _ = tapi.bsrsv_get_info(h, p)
    assert st == 0 and resid <= 1e-10 and iters > 0 and flops > 0
    ps = tapi._PLANS[p]
    assert ps.x_refined is not None
    st, xval = tapi.bsrsv_get_matrix(h, p, "X", "z")
    xc = _complex(xval)
    np.testing.assert_array_equal(xc, ps.x_refined)
    r = dense_from_bsr(a, lm, lm) @ dense_from_bsr(x.with_data(xc), lm, ln) \
        - dense_from_bsr(b, lm, ln)
    assert np.max(np.abs(r)) < 1e-8
    st, xt = tapi.bsrsv_get_matrix(h, p, "X", "z", trans="t")
    np.testing.assert_array_equal(_complex(xt), np.swapaxes(xc, 1, 2))
    # the same 'm' solve in the JAX package: status and the gate
    st, jh = japi.create_handle()
    st, jx, jit, jres = japi.bsrsv_m(
        a.nrows, lm, ln, a.rowptr, a.colind, _riri(a.data), "n",
        x.rowptr, x.colind, None, "n", b.rowptr, b.colind, _riri(b.data),
        "n", max_iterations=400, threshold=1e-10)
    assert st == 0
    assert np.max(np.abs(_complex(jx) - xc)) <= 1e-8 * np.max(np.abs(xc))
    tapi.bsrsv_destroy_plan(h, p)
    tapi.destroy_handle(h)
    japi.destroy_handle(jh)


def test_mixed_plan_api_fallback_matches_solve_mixed(monkeypatch):
    """With one round of refinement the iterate stays unconverged and 'm'
    restarts in complex128: the plan API and ``solve_mixed`` run the same
    stages (``solver.mixed_stages``) with the same seeded v3, so they agree
    on status, iterations and X (to 1e-12 relative)."""
    from tfqmrgpu_tpu_torch import solver as tsolver
    monkeypatch.setattr(tsolver, "refine_mixed",
                        functools.partial(tsolver.refine_mixed, max_rounds=1))
    lm = ln = 4
    a, x, b = make_random_problem(np.random.default_rng(7), mb=10, lm=lm,
                                  ln=ln, ncols=2, x_fill=1.0)
    xs, info = tsolver.bsrsv_m(*(TBsr(m.nrows, m.ncols, m.rowptr, m.colind,
                                      m.data, m.name) for m in (a, x, b)),
                               tolerance=1e-10, max_iterations=500,
                               device="cpu")
    assert info.refinement["fallback"] and info.return_status == 0
    st, h = tapi.create_handle(device="cpu")
    st, p = tapi.bsrsv_create_plan(h, a.nrows, a.rowptr, a.colind,
                                   x.rowptr, x.colind, b.rowptr, b.colind)
    st, _ = tapi.bsrsv_buffer_size(h, p, lm, lm, ln, ln, "m")
    assert tapi.bsrsv_set_buffer(h, p) == 0
    assert tapi.bsrsv_set_matrix(h, p, "A", _riri(a.data), "z") == 0
    assert tapi.bsrsv_set_matrix(h, p, "B", _riri(b.data), "z") == 0
    assert tapi.bsrsv_solve(h, p, 1e-10, 500) == 0
    st, resid, iters, _, _ = tapi.bsrsv_get_info(h, p)
    assert (st, iters) == (0, info.iterations_needed)
    assert resid == info.residuum_reached
    st, xval = tapi.bsrsv_get_matrix(h, p, "X", "z")
    xc = _complex(xval)
    assert np.max(np.abs(xc - xs.data)) <= 1e-12 * np.max(np.abs(xs.data))
    assert _pattern_residual(a, x, b, xc, lm, ln) < 1e-8
    tapi.bsrsv_destroy_plan(h, p)
    tapi.destroy_handle(h)


@pytest.mark.parametrize("precision", ["z", "c", "m"])
def test_one_call_on_cpu(rng, precision):
    lm = ln = 4
    dtype = np.complex64 if precision == "c" else np.complex128
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  dtype=dtype)
    dt = np.float32 if precision == "c" else np.float64
    fn = getattr(tapi, f"bsrsv_{precision}")
    n_handles, n_plans = len(tapi._HANDLES), len(tapi._PLANS)
    tol = 1e-4 if precision == "c" else 1e-9
    st, xval, iters, resid = fn(
        a.nrows, lm, ln, a.rowptr, a.colind, _riri(a.data, dt), "n",
        x.rowptr, x.colind, None, "n", b.rowptr, b.colind, _riri(b.data, dt),
        "n", max_iterations=300, threshold=tol, device="cpu")
    assert st == 0 and 0 < iters and resid <= tol
    assert xval.shape == (x.nnzb, lm, ln, 2)
    assert len(tapi._HANDLES) == n_handles and len(tapi._PLANS) == n_plans


def test_no_card_gives_no_implementation(rng, monkeypatch):
    """The default device is the card: without one, a handle and a
    one-call solve return NO_IMPLEMENTATION and nothing runs on the CPU."""
    from tfqmrgpu_tpu_torch import solver as tsolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args, **kwargs):
        raise AssertionError("nothing may run without a card")

    monkeypatch.setattr(tsolver.Solver, "__init__", refuse)
    st, h = tapi.create_handle()
    assert (decode_status(st)[0], h) == (int(Status.NO_IMPLEMENTATION), 0)
    a, x, b = make_random_problem(rng, mb=6, lm=4, ln=4, ncols=2)
    n_handles = len(tapi._HANDLES)
    st, xval, iters, resid = tapi.bsrsv_z(
        a.nrows, 4, 4, a.rowptr, a.colind, _riri(a.data), "n",
        x.rowptr, x.colind, None, "n", b.rowptr, b.colind, _riri(b.data),
        "n")
    assert decode_status(st)[0] == int(Status.NO_IMPLEMENTATION)
    assert (xval, iters, resid) == (None, 0, 0.0)
    assert len(tapi._HANDLES) == n_handles


def test_only_status_errors_become_statuses(monkeypatch):
    """_catch turns TfqmrgpuError and KeyError into statuses; any other
    exception propagates (the C side reports it as UNDOCUMENTED_ERROR)."""
    st, h = tapi.create_handle(device="cpu")
    assert decode_status(tapi.bsrsv_buffer_size(h, 987654, 4, 4, 4, 4, "z"))[
        0] == int(Status.POINTER_INVALID)

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tapi, "create_plan", boom)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tapi.bsrsv_create_plan(h, 1, [0, 1], [0], [0, 1], [0], [0, 1], [0])
    tapi.destroy_handle(h)


# ------------------------------------------------------------ Bsr, Plan

def test_bsr_scipy_round_trip_and_pattern_key(rng):
    a, x, b = make_random_problem(rng, mb=7, lm=3, ln=5, ncols=2)
    for m in (a, b):
        t = TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
        assert t.pattern_key() == m.pattern_key()      # the JAX bytes
        sp = t.to_scipy_bsr()
        np.testing.assert_array_equal(sp.toarray(), m.to_scipy_bsr().toarray())
        back = TBsr.from_scipy_bsr(sp, name=m.name)
        assert (back.nrows, back.ncols) == (m.nrows, m.ncols)
        np.testing.assert_array_equal(back.rowptr, m.rowptr)
        np.testing.assert_array_equal(back.colind, m.colind)
        np.testing.assert_array_equal(back.data, m.data)
        assert back.pattern_key() == JBsr.from_scipy_bsr(sp).pattern_key()
    # a CSR matrix goes through tobsr
    csr = a.to_scipy_bsr().tocsr()
    assert TBsr.from_scipy_bsr(csr).nnzb >= 1
    assert BlockSparseMatrix is TBsr
    with pytest.raises(ValueError):
        TBsr(2, 2, [0, 1, 2], [0, 1]).to_scipy_bsr()
    other = TBsr(a.nrows, a.ncols, a.rowptr, (a.colind + 1) % a.ncols)
    assert other.pattern_key() != TBsr(a.nrows, a.ncols, a.rowptr,
                                       a.colind).pattern_key()
    assert make_bsr(2, 2, [0, 1, 2], [0, 1]).nnzb == 2
    with pytest.raises(TfqmrgpuError):
        make_bsr(2, 2, [0, 2, 1], [0, 1])


@pytest.mark.parametrize("precision", ["z", "c"])
def test_memory_requirement_bytes_matches_jax(rng, precision):
    a, x, b = make_random_problem(rng, mb=12, lm=4, ln=8, ncols=4)
    jp = jcreate_plan(a, x, b, cache=False)
    tp = tplan.create_plan(*(TBsr(m.nrows, m.ncols, m.rowptr, m.colind,
                                  m.data, m.name) for m in (a, x, b)),
                           device="cpu")
    for lm, ln in ((4, 8), (4, 4), (8, 32)):
        assert tp.memory_requirement_bytes(lm, ln, precision) == \
            jp.memory_requirement_bytes(lm, ln, precision)


def test_plan_cache(rng, monkeypatch):
    """A hit returns a shallow copy with fresh statistics; the key holds the
    device, so a CPU plan is never handed out for another device; 16
    entries, first in, first out."""
    monkeypatch.setattr(tplan, "_PLAN_CACHE", {})
    a, x, b = (TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
               for m in make_random_problem(rng, mb=9, lm=4, ln=4, ncols=3))
    p1 = tplan.create_plan(a, x, b, device="cpu")
    p1.iterations_needed, p1.residuum_reached = 17, 1e-3
    p1.flops_performed_all = 5.0
    p2 = tplan.create_plan(a, x, b, device="cpu")
    assert p2 is not p1 and p2.starts is p1.starts          # a hit
    assert (p2.iterations_needed, p2.residuum_reached,
            p2.flops_performed, p2.flops_performed_all) == (-1, -1.0, -1.0,
                                                            0.0)
    other = tplan.create_plan(a, x, b, device="meta")
    assert other.starts.device.type == "meta"
    assert tplan.create_plan(a, x, b, device="cpu").starts.device.type == "cpu"
    assert len(tplan._PLAN_CACHE) == 2
    p3 = tplan._build_plan(a, x, b, 0, 0, torch.device("cpu"))
    assert p3.starts is not p1.starts
    torch.testing.assert_close(p3.pairs, p1.pairs)
    for shift in range(1, 16):
        xs = TBsr(x.nrows, x.ncols + shift, x.rowptr, x.colind + shift)
        bs = TBsr(b.nrows, b.ncols + shift, b.rowptr, b.colind + shift)
        tplan.create_plan(a, xs, bs, device="cpu")
    assert len(tplan._PLAN_CACHE) == 16
    # the first entry (the CPU plan) went first
    assert tplan.create_plan(a, x, b, device="cpu").starts is not p1.starts

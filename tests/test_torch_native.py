"""The port's C library, ``libtfqmrgpu_tpu_torch.so``, through ctypes.

* Its C++ analysis step (``native.native_plan_tables``) gives the tables of
  the port's ``create_plan`` bit for bit at index offsets 0 and 1, and the
  same packed B_IS_NOT_SUBSET_OF_X code.
* The ten-step C workflow on a CPU handle (made with
  ``api.create_handle(device="cpu")``; the C library runs in this
  interpreter) gives the Python API's X to the last bit, and the mixed
  precision 'm' data travels as double arrays.
* Without a card, the C one-call solvers and tfqmrgpuCreateHandle return
  NO_IMPLEMENTATION; an exception in Python comes back as
  UNDOCUMENTED_ERROR, never as SUCCESS.
* -Bsymbolic: with the JAX package's library (same symbol names) loaded
  first with RTLD_GLOBAL, the port's Fortran wrappers still reach the
  port's C API and ``api``.
* The build: hashed directory, raise on failure.
"""

import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chip_smoke import c_onecall, riri
from tfqmrgpu_tpu_torch import api, capi_bridge, native
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.errors import Status, TfqmrgpuError
from tfqmrgpu_tpu_torch.plan import create_plan
from conftest import make_random_problem

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(*bsrs):
    return [TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
            for m in bsrs]


def _i32(v, offset=0):
    return np.ascontiguousarray(np.asarray(v, np.int32) + offset)


@pytest.fixture(scope="module")
def lib():
    return native.load()


@pytest.mark.parametrize("offset", [0, 1])
def test_native_plan_matches_create_plan(rng, offset):
    for trial in range(3):
        a, x, b = make_random_problem(rng, mb=12, lm=4, ln=4, ncols=5,
                                      x_fill=0.5, seed_shift=trial)
        plan = create_plan(*_port(a, x, b), device="cpu")
        shifted = create_plan(
            *(TBsr(m.nrows, m.ncols, m.rowptr + offset, m.colind + offset)
              for m in (a, x, b)), index_offset=offset, device="cpu")
        starts, pairs, subset, colindx, orig = native.native_plan_tables(
            a.nrows, offset, *(_i32(v, offset) for v in (
                a.rowptr, a.colind, x.rowptr, x.colind, b.rowptr, b.colind)))
        for p in (plan, shifted):
            assert starts.dtype == np.uint32 and colindx.dtype == np.uint16
            np.testing.assert_array_equal(starts, p.starts.numpy())
            np.testing.assert_array_equal(pairs, p.pairs.numpy())
            np.testing.assert_array_equal(subset, p.subset.numpy())
            np.testing.assert_array_equal(colindx, p.colindx.numpy())
        # column compression works on the RAW indices (tfqmrgpu.cu:254):
        # a constant shift leaves the compressed ids unchanged
        np.testing.assert_array_equal(orig, plan.original_colind_x + offset)
        np.testing.assert_array_equal(orig, shifted.original_colind_x)


def test_native_b_not_subset_status(rng):
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2)
    bad_rowptr_b = np.zeros(9, np.int32)
    bad_rowptr_b[1:] = 1
    bad_colind_b = np.array([x.ncols + 7], np.int32)
    with pytest.raises(TfqmrgpuError) as native_err:
        native.native_plan_tables(a.nrows, 0, a.rowptr, a.colind,
                                  x.rowptr, x.colind,
                                  bad_rowptr_b, bad_colind_b)
    with pytest.raises(TfqmrgpuError) as plan_err:
        create_plan(*_port(a, x, TBsr(8, 2, bad_rowptr_b, bad_colind_b)),
                    device="cpu")
    assert native_err.value.code == int(Status.B_IS_NOT_SUBSET_OF_X)
    assert native_err.value.status == plan_err.value.status


def _c_ten_steps(lib, handle, a, x, b, lm, ln, precision="z"):
    """createPlan ... getMatrix through the C ABI on ``handle``; returns
    (bufferSize, solve status, iterations, X complex)."""
    ptrs = [_i32(v) for v in (a.rowptr, a.colind, x.rowptr, x.colind,
                              b.rowptr, b.colind)]
    plan = ctypes.c_int64(0)
    st = lib.tfqmrgpu_bsrsv_createPlan(
        handle, ctypes.byref(plan), a.nrows,
        ptrs[0].ctypes.data, a.nnzb, ptrs[1].ctypes.data,
        ptrs[2].ctypes.data, x.nnzb, ptrs[3].ctypes.data,
        ptrs[4].ctypes.data, b.nnzb, ptrs[5].ctypes.data, 0, 0)
    assert st == 0 and plan.value in api._PLANS
    size = ctypes.c_size_t(0)
    assert lib.tfqmrgpu_bsrsv_bufferSize(handle, plan, lm, lm, ln, ln,
                                         precision.encode(),
                                         ctypes.byref(size)) == 0
    buf = ctypes.c_void_p(0)
    assert lib.tfqmrgpuCreateWorkspace(ctypes.byref(buf), size.value,
                                       b"d") == 0
    assert lib.tfqmrgpu_bsrsv_setBuffer(handle, plan, buf) == 0
    token = ctypes.c_void_p(0)
    assert lib.tfqmrgpu_bsrsv_getBuffer(handle, plan,
                                        ctypes.byref(token)) == 0
    assert token.value == buf.value
    dt = np.float32 if precision == "c" else np.float64
    amat, bmat = riri(a.data, dt), riri(b.data, dt)
    for var, val, d2 in ((b"A", amat, lm), (b"B", bmat, ln)):
        assert lib.tfqmrgpu_bsrsv_setMatrix(
            handle, plan, var, val.ctypes.data, precision.encode(), lm, d2,
            b"n", 0x55) == 0
    solve_st = lib.tfqmrgpu_bsrsv_solve(handle, plan, 1e-10, 300)
    resid, iters = ctypes.c_double(0), ctypes.c_int32(0)
    flops, flops_all = ctypes.c_double(0), ctypes.c_double(0)
    assert lib.tfqmrgpu_bsrsv_getInfo(
        handle, plan, ctypes.byref(resid), ctypes.byref(iters),
        ctypes.byref(flops), ctypes.byref(flops_all)) == 0
    xmat = np.zeros((x.nnzb, lm, ln, 2), dt)
    assert lib.tfqmrgpu_bsrsv_getMatrix(
        handle, plan, b"X", xmat.ctypes.data, precision.encode(), lm, ln,
        b"n", 0x55) == 0
    assert lib.tfqmrgpu_bsrsv_destroyPlan(handle, plan) == 0
    assert plan.value not in api._PLANS
    assert lib.tfqmrgpuDestroyWorkspace(buf) == 0
    return size.value, solve_st, iters.value, xmat[..., 0] + 1j * xmat[..., 1]


@pytest.mark.parametrize("precision", ["z", "m"])
def test_c_ten_steps_on_a_cpu_handle(rng, lib, precision):
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0)
    st, h = api.create_handle(device="cpu")
    stream = ctypes.c_int64(0)
    assert lib.tfqmrgpuSetStream(h, 7) == 0
    assert lib.tfqmrgpuGetStream(h, ctypes.byref(stream)) == 0
    assert stream.value == 7
    nbytes, st, iters, xc = _c_ten_steps(lib, h, a, x, b, lm, ln, precision)
    assert st == 0 and iters > 0
    # the same steps through the Python API give the same bits
    st, p = api.bsrsv_create_plan(h, a.nrows, a.rowptr, a.colind,
                                  x.rowptr, x.colind, b.rowptr, b.colind)
    assert api.bsrsv_buffer_size(h, p, lm, lm, ln, ln, precision) == (0, nbytes)
    api.bsrsv_set_buffer(h, p)
    api.bsrsv_set_matrix(h, p, "A", a.data)
    api.bsrsv_set_matrix(h, p, "B", b.data)
    assert api.bsrsv_solve(h, p, 1e-10, 300) == 0
    assert api.bsrsv_get_info(h, p)[2] == iters
    st, want = api.bsrsv_get_matrix(h, p, "X", precision, layout=0x55)
    np.testing.assert_array_equal(xc, want[..., 0] + 1j * want[..., 1])
    api.bsrsv_destroy_plan(h, p)
    assert lib.tfqmrgpuDestroyHandle(h) == 0
    assert h not in api._HANDLES


def test_c_status_codes(rng, lib):
    assert lib.tfqmrgpuDestroyHandle(987654) == int(Status.POINTER_INVALID)
    assert lib.tfqmrgpu_bsrsv_destroyPlan(0, 987654) == int(
        Status.POINTER_INVALID)
    number = ctypes.c_int32(0)
    sizes = np.zeros(64, np.int32)
    assert lib.tfqmrgpu_bsrsv_allowedBlockSizes(ctypes.byref(number),
                                                sizes.ctypes.data, 64) == 0
    flat = api.bsrsv_allowed_block_sizes()[2]
    assert number.value == 15 and sizes[:30].tolist() == flat
    assert lib.tfqmrgpu_bsrsv_blockSizeMissing(32, 32) == 0
    assert lib.tfqmrgpu_bsrsv_blockSizeMissing(3, 7) == int(
        Status.BLOCKSIZE_MISSING)
    assert b"subset" in lib.tfqmrgpuGetErrorString(13)
    assert b"line 5" in lib.tfqmrgpuGetErrorString(5003)
    # B not a subset of X, through createPlan
    a, x, b = make_random_problem(rng, mb=6, lm=4, ln=4, ncols=2)
    st, h = api.create_handle(device="cpu")
    bad_rowptr_b = _i32([0] + [1] * 6)
    bad_colind_b = _i32([x.ncols + 3])
    rpa, cia, rpx, cix = (_i32(v) for v in (a.rowptr, a.colind, x.rowptr,
                                            x.colind))
    plan = ctypes.c_int64(0)
    st = lib.tfqmrgpu_bsrsv_createPlan(
        h, ctypes.byref(plan), a.nrows, rpa.ctypes.data, a.nnzb,
        cia.ctypes.data, rpx.ctypes.data, x.nnzb, cix.ctypes.data,
        bad_rowptr_b.ctypes.data, 1, bad_colind_b.ctypes.data, 0, 0)
    assert st % 1000 == int(Status.B_IS_NOT_SUBSET_OF_X)
    assert st == api.bsrsv_create_plan(h, a.nrows, a.rowptr, a.colind,
                                       x.rowptr, x.colind, bad_rowptr_b,
                                       bad_colind_b)
    api.destroy_handle(h)


@pytest.mark.parametrize("precision", ["z", "c", "m"])
def test_c_one_call_without_card(rng, lib, monkeypatch, precision):
    """The C entry points resolve the device like every other entry point:
    without a card they return NO_IMPLEMENTATION and run nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, x, b = make_random_problem(rng, mb=6, lm=4, ln=4, ncols=2)
    n_handles = len(api._HANDLES)
    st, xc, iters, resid, _ = c_onecall(lib, precision, a, x, b, 1e-9, 100)
    assert st == int(Status.NO_IMPLEMENTATION)
    assert (iters, resid) == (0, 0.0) and not xc.any()
    handle = ctypes.c_int64(0)
    assert lib.tfqmrgpuCreateHandle(ctypes.byref(handle)) == int(
        Status.NO_IMPLEMENTATION)
    assert handle.value == 0 and len(api._HANDLES) == n_handles


def test_python_exception_is_undocumented_error(lib, monkeypatch):
    def boom(*args):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(capi_bridge, "h_destroy", boom)
    monkeypatch.setattr(capi_bridge, "plan_destroy", lambda h, p: "not an int")
    assert lib.tfqmrgpuDestroyHandle(1) == int(Status.UNDOCUMENTED_ERROR)
    assert lib.tfqmrgpu_bsrsv_destroyPlan(1, 1) == int(
        Status.UNDOCUMENTED_ERROR)


def test_bsymbolic_isolation_from_the_jax_library(lib):
    """The JAX package's library exports the same names; loaded first with
    RTLD_GLOBAL (as its loader does), it must not capture the port's own
    calls: the port's Fortran wrapper reaches the port's C API and its
    ``capi_bridge``.  A fresh process, since ctypes binds a library's
    symbols when it loads it."""
    from tfqmrgpu_tpu import native as jnative

    if jnative.load_capi() is None:
        pytest.skip("the JAX package's C library did not build")
    code = textwrap.dedent(f"""
        import ctypes
        ctypes.CDLL({jnative.os.path.join(jnative._LIB_DIR,
                                          "libtfqmrgpu_tpu.so")!r},
                    mode=ctypes.RTLD_GLOBAL)
        from tfqmrgpu_tpu_torch import capi_bridge, native
        capi_bridge.h_create = lambda: 4242
        handle, status = ctypes.c_int64(-1), ctypes.c_int32(-1)
        native.load().tfqmrgpucreatehandle_(ctypes.byref(handle),
                                            ctypes.byref(status))
        print("handle", status.value, handle.value)
        """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert "handle 0 4242" in r.stdout, r.stdout + r.stderr


def test_build_is_hashed_and_raises(monkeypatch, tmp_path):
    path = native.library_path()
    assert path.parent.parent == native.BUILD_ROOT
    assert path == native.library_path()
    assert native.build() == (path, 0.0)            # already built
    flags = native.link_flags()
    assert f"-I{native.INCLUDE_DIR}" in flags and "-ltfqmrgpu_tpu_torch" in flags
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native.build()
    assert not list((tmp_path / "native").rglob("*.so"))

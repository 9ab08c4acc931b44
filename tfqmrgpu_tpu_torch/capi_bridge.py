"""Bridge between the port's C library (capi/src/capi.cpp) and api.py.

The C library embeds CPython and calls the functions here with raw pointer
ADDRESSES (int64) plus sizes; this module views the memory with ctypes and
numpy, calls the C-API-parity layer (api.py), and returns plain integers:

    >= 0 : result value (handle id, plan id, byte count, ...)
    <  0 : negated packed tfqmrgpuStatus_t

Foreign memory is copied before it reaches the solver, so that no array or
tensor aliases a C caller's buffer after the call returns.  Only the
statuses ``api`` returns become negative results here; any other exception
propagates, and the C side reports it as UNDOCUMENTED_ERROR.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import api
from .errors import Status, encode_status

_PTR = {
    np.int32: ctypes.POINTER(ctypes.c_int32),
    np.float32: ctypes.POINTER(ctypes.c_float),
    np.float64: ctypes.POINTER(ctypes.c_double),
}


def _view(addr: int, n: int, dtype):
    """numpy view of foreign memory at ``addr`` holding ``n`` items."""
    if addr == 0:
        raise ValueError("NULL pointer")
    ptr = ctypes.cast(int(addr), _PTR[dtype])
    return np.ctypeslib.as_array(ptr, shape=(int(n),))


def _store(addr: int, ctype, value):
    """Write one C scalar to ``addr`` (a NULL address is skipped)."""
    if addr:
        ctypes.cast(int(addr), ctypes.POINTER(ctype))[0] = value


def _neg(status: int) -> int:
    return -int(status) if status else 0


def _real_dtype(precision: str):
    """The C caller's element type: double for 'z' and 'm', float for 'c'
    (tfqmrgpu_tpu_torch.h)."""
    return np.float64 if precision in ("z", "m") else np.float32


# ------------------------------------------------------------- handles

def h_create() -> int:
    st, h = api.create_handle()
    return h if st == 0 else _neg(st)


def h_destroy(h: int) -> int:
    return _neg(api.destroy_handle(h))


def h_set_stream(h: int, s: int) -> int:
    return _neg(api.set_stream(h, s))


def h_get_stream(h: int, addr_out: int) -> int:
    st, s = api.get_stream(h)
    if st == 0:
        _store(addr_out, ctypes.c_int64, s)
    return _neg(st)


# ---------------------------------------------------------------- plans

def plan_create(h: int, mb: int,
                addr_rowptr_a: int, nnzb_a: int, addr_colind_a: int,
                addr_rowptr_x: int, nnzb_x: int, addr_colind_x: int,
                addr_rowptr_b: int, nnzb_b: int, addr_colind_b: int,
                index_offset: int, echo: int) -> int:
    out = api.bsrsv_create_plan(
        h, mb,
        _view(addr_rowptr_a, mb + 1, np.int32).copy(),
        _view(addr_colind_a, nnzb_a, np.int32).copy(),
        _view(addr_rowptr_x, mb + 1, np.int32).copy(),
        _view(addr_colind_x, nnzb_x, np.int32).copy(),
        _view(addr_rowptr_b, mb + 1, np.int32).copy(),
        _view(addr_colind_b, nnzb_b, np.int32).copy(),
        index_offset, echo)
    if isinstance(out, int):
        return _neg(out)
    return out[1]


def plan_destroy(h: int, p: int) -> int:
    return _neg(api.bsrsv_destroy_plan(h, p))


def buffer_size(h: int, p: int, ld_a: int, block_dim: int, ld_b: int,
                rhs_block_dim: int, precision: int) -> int:
    out = api.bsrsv_buffer_size(h, p, ld_a, block_dim, ld_b, rhs_block_dim,
                                chr(precision))
    if isinstance(out, int):
        return _neg(out)
    return out[1]


def set_buffer(h: int, p: int, token: int) -> int:
    return _neg(api.bsrsv_set_buffer(h, p, token or 1))


def get_buffer(h: int, p: int, addr_out: int) -> int:
    st, tok = api.bsrsv_get_buffer(h, p)
    if st == 0:
        _store(addr_out, ctypes.c_int64, tok)
    return _neg(st)


# ------------------------------------------------------------- matrices

def _plan_nnzb(p: int, var: str) -> int:
    ps = api._PLANS.get(int(p))
    if ps is None:
        return -1
    return {"A": ps.plan.nnzb_a, "X": ps.plan.nnzb_x,
            "B": ps.plan.nnzb_b}.get(var, -1)


def set_matrix(h: int, p: int, var: int, addr_val: int, precision: int,
               ld: int, d2: int, trans: int, layout: int) -> int:
    v = chr(var).upper()
    nnzb = _plan_nnzb(p, v)
    if nnzb < 0:
        return _neg(encode_status(Status.VARIABLENAME_UNKNOWN, 0, v))
    val = _view(addr_val, nnzb * ld * d2 * 2,
                _real_dtype(chr(precision))).copy()
    return _neg(api.bsrsv_set_matrix(h, p, v, val, chr(precision),
                                     ld, d2, chr(trans), layout))


def get_matrix(h: int, p: int, var: int, addr_val: int, precision: int,
               ld: int, d2: int, trans: int, layout: int) -> int:
    v = chr(var).upper()
    nnzb = _plan_nnzb(p, v)
    if nnzb < 0:
        return _neg(encode_status(Status.VARIABLENAME_UNKNOWN, 0, v))
    out = api.bsrsv_get_matrix(h, p, v, chr(precision), ld, d2,
                               chr(trans), layout)
    if isinstance(out, int):
        return _neg(out)
    val = np.asarray(out[1]).reshape(-1)
    _view(addr_val, val.size, _real_dtype(chr(precision)))[:] = val
    return 0


# ------------------------------------------------------------------ solve

def solve(h: int, p: int, threshold: float, max_iterations: int) -> int:
    return _neg(api.bsrsv_solve(h, p, threshold, max_iterations))


def get_info(h: int, p: int, addr_resid: int, addr_iters: int,
             addr_flops: int, addr_flops_all: int) -> int:
    st, resid, iters, flops, flops_all = api.bsrsv_get_info(h, p)
    if st == 0:
        _store(addr_resid, ctypes.c_double, float(resid))
        _store(addr_iters, ctypes.c_int32, int(iters))
        _store(addr_flops, ctypes.c_double, float(flops))
        _store(addr_flops_all, ctypes.c_double, float(flops_all))
    return _neg(st)


# ------------------------------------------------------- introspection

def allowed_block_sizes(addr_number: int, addr_sizes: int,
                        array_length: int) -> int:
    st, n, flat = api.bsrsv_allowed_block_sizes(array_length)
    _store(addr_number, ctypes.c_int32, n)
    if addr_sizes and flat:
        _view(addr_sizes, len(flat), np.int32)[:] = flat
    return _neg(st)


def block_size_missing(ld_a: int, ld_b: int) -> int:
    return _neg(api.bsrsv_block_size_missing(ld_a, ld_b))


# --------------------------------------------------- one-call wrappers

def _onecall(precision: str, mb: int, ld_a: int, ld_b: int,
             addr_rowptr_a: int, nnzb_a: int, addr_colind_a: int,
             addr_amat: int, trans_a: int,
             addr_rowptr_x: int, nnzb_x: int, addr_colind_x: int,
             addr_xmat: int, trans_x: int,
             addr_rowptr_b: int, nnzb_b: int, addr_colind_b: int,
             addr_bmat: int, trans_b: int,
             addr_iterations: int, addr_residual: int,
             index_offset: int, echo: int) -> int:
    dt = _real_dtype(precision)
    it_ptr = ctypes.cast(int(addr_iterations), ctypes.POINTER(ctypes.c_int32))
    res_ptr = ctypes.cast(int(addr_residual), ctypes.POINTER(ctypes.c_float))
    maxiter = int(it_ptr[0])
    threshold = float(res_ptr[0])
    fn = {"z": api.bsrsv_z, "c": api.bsrsv_c, "m": api.bsrsv_m}[precision]
    st, xval, iters, resid = fn(
        mb, ld_a, ld_b,
        _view(addr_rowptr_a, mb + 1, np.int32).copy(),
        _view(addr_colind_a, nnzb_a, np.int32).copy(),
        _view(addr_amat, nnzb_a * ld_a * ld_a * 2, dt).copy(), chr(trans_a),
        _view(addr_rowptr_x, mb + 1, np.int32).copy(),
        _view(addr_colind_x, nnzb_x, np.int32).copy(),
        None, chr(trans_x),
        _view(addr_rowptr_b, mb + 1, np.int32).copy(),
        _view(addr_colind_b, nnzb_b, np.int32).copy(),
        _view(addr_bmat, nnzb_b * ld_a * ld_b * 2, dt).copy(), chr(trans_b),
        max_iterations=maxiter, threshold=threshold,
        index_offset=index_offset, echo=echo)
    if xval is not None:
        _view(addr_xmat, nnzb_x * ld_a * ld_b * 2, dt)[:] = \
            np.asarray(xval).reshape(-1)
    it_ptr[0] = int(iters)
    res_ptr[0] = float(resid)
    return _neg(st)


def bsrsv_z(*args) -> int:
    return _onecall("z", *args)


def bsrsv_c(*args) -> int:
    return _onecall("c", *args)


def bsrsv_m(*args) -> int:
    """Mixed precision: 'c' iterations + float64 refinement on double
    arrays."""
    return _onecall("m", *args)

"""Call-by-call C-API-parity layer (the reference's 20-function surface).

The reference exposes a plan-based C API (tfqmrgpu.h:16-156) with opaque
handle/plan pointers, status-code returns, and a fixed 10-step default
workflow (tfqmrgpu.cu:700-791):

    createHandle -> setStream -> createPlan -> bufferSize -> createWorkspace
    -> setBuffer -> setMatrix('A'/'B') -> solve -> getInfo -> getMatrix('X')
    -> destroy*

This module reproduces that workflow one to one over the port's ``Solver``,
with the JAX package's function names, arguments, return tuples and packed
status codes, so that a user or a foreign-language binding (the C library
of ``capi/``, through ``capi_bridge.py``) drives the solver on the CUDA
card with the same call sequence.  Handles and plans are small integer ids
into module-level registries; every function RETURNS a packed
``tfqmrgpuStatus_t`` (0 success, reference encoding: code + 1000*line +
10^7*char, tfqmrgpu.h:179-181) instead of raising.

Semantics of the port (documented departures from the reference):
  * a handle owns a device: ``create_handle(device=None)`` resolves it with
    ``plan.resolve_device`` (the CUDA card unless the caller asks for
    another), and every plan, ``Solver`` and one-call solve made under the
    handle runs there.  Without a card the default gives the packed
    NO_IMPLEMENTATION status; nothing falls back to the CPU.
  * ``setStream``/``getStream`` store the value only; the solve runs on
    PyTorch's current stream.
  * ``bufferSize`` returns the analytic device-memory estimate
    (``Plan.memory_requirement_bytes``); PyTorch's caching allocator
    allocates for real, so ``createWorkspace`` hands out an opaque token and
    ``setBuffer`` performs the state setup the reference does there (the
    shadow vector v3, the engine and its device tables).
  * precision 'm' (mixed) runs the port's mixed pipeline: complex64
    iterations, float64-residual iterative refinement
    (``solver.mixed_stages``), and a complex128 re-solve if refinement
    stalls -- the mode the reference declares but disables
    (tfqmrgpu.cu:42).  The refined X is kept in the plan's state and
    returned by ``bsrsv_get_matrix``.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import allowed_block_sizes as _allowed_block_sizes
from . import block_size_missing as _block_size_missing
from .bsr import Bsr
from .errors import Status, TfqmrgpuError, encode_status, get_error_string
from .ops import layout as layout_ops
from .plan import Plan, create_plan, resolve_device
from .solver import Solver, _scatter_to_x, mixed_stages

SUCCESS = int(Status.SUCCESS)

_ids = itertools.count(1)
_HANDLES: Dict[int, "_Handle"] = {}
_PLANS: Dict[int, "_PlanState"] = {}
_WORKSPACES: Dict[int, int] = {}


@dataclass
class _Handle:
    """All library state besides plans: the reference's handle is one
    stream id (tfqmrgpu_handle.hxx:4-6); the port's also names the
    device."""

    device: torch.device
    stream: int = 0


@dataclass
class _PlanState:
    plan: Plan                     # on the handle's device
    echo: int = 0
    lm: int = 0
    ln: int = 0
    precision: str = "?"
    buffer_token: int = 0          # 0 = setBuffer not called yet
    solver: Optional[Solver] = None
    x_refined: Optional[np.ndarray] = None  # X of the last 'm' solve
    pending: Dict[str, Any] = field(default_factory=dict)  # matrices set
    raw: Dict[str, Any] = field(default_factory=dict)      # host copies for 'm'
    bsr_a: Optional[Bsr] = None
    bsr_x: Optional[Bsr] = None
    bsr_b: Optional[Bsr] = None


def _catch(fn):
    """Turn a raised TfqmrgpuError into its packed status, and an unknown
    id (KeyError) into POINTER_INVALID.  Every other exception propagates:
    the C bridge reports it as UNDOCUMENTED_ERROR."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except TfqmrgpuError as e:
            return e.status
        except KeyError:
            return encode_status(Status.POINTER_INVALID)
    return wrapper


def _char(v) -> str:
    """A C ``char`` argument (int) or a Python one-character string."""
    return chr(v) if isinstance(v, int) else v


# --------------------------------------------------------------- error API

def print_error(status: int) -> int:
    """tfqmrgpuPrintError (tfqmrgpu_error_tool.cxx:67-77)."""
    print(f"tfqmrgpu status {int(status)}: {get_error_string(status)}")
    return SUCCESS


# ------------------------------------------------------------- handle mgmt

def create_handle(device=None) -> tuple[int, int]:
    """tfqmrgpuCreateHandle -> (status, handle_id).  The handle runs on
    ``device``, the CUDA card unless given; without a card the default
    returns (NO_IMPLEMENTATION, 0)."""
    try:
        dev = resolve_device(device)
    except TfqmrgpuError as e:
        return e.status, 0
    hid = next(_ids)
    _HANDLES[hid] = _Handle(device=dev)
    return SUCCESS, hid


def destroy_handle(handle: int) -> int:
    if _HANDLES.pop(int(handle), None) is None:
        return encode_status(Status.POINTER_INVALID)
    return SUCCESS


def set_stream(handle: int, stream: int) -> int:
    """Stored only; the solve runs on PyTorch's current stream."""
    h = _HANDLES.get(int(handle))
    if h is None:
        return encode_status(Status.POINTER_INVALID)
    h.stream = int(stream)
    return SUCCESS


def get_stream(handle: int) -> tuple[int, int]:
    h = _HANDLES.get(int(handle))
    if h is None:
        return encode_status(Status.POINTER_INVALID), 0
    return SUCCESS, h.stream


# ---------------------------------------------------------- workspace mgmt

def create_workspace(size_in_bytes: int, mem_type: str = "d") -> tuple[int, int]:
    """tfqmrgpuCreateWorkspace parity (tfqmrgpu.cu:682-694).  PyTorch owns
    device memory, so the returned value is an opaque nonzero token."""
    del mem_type
    token = next(_ids)
    _WORKSPACES[token] = int(size_in_bytes)
    return SUCCESS, token


def destroy_workspace(token: int) -> int:
    if _WORKSPACES.pop(int(token), None) is None:
        return encode_status(Status.POINTER_INVALID)
    return SUCCESS


# ---------------------------------------------------------- introspection

def bsrsv_allowed_block_sizes(array_length: int = 1 << 30) -> tuple[int, int, list]:
    """tfqmrgpu_bsrsv_allowedBlockSizes -> (status, number, flat_pairs)."""
    sizes = _allowed_block_sizes()
    flat = [v for lm_ln in sizes for v in lm_ln]
    return SUCCESS, len(sizes), flat[: max(0, int(array_length))]


def bsrsv_block_size_missing(ld_a: int, ld_b: int) -> int:
    """tfqmrgpu_bsrsv_blockSizeMissing: 0 if (ldA, ldB) is in the
    reference's compiled list, which is the list the kernels take."""
    return _block_size_missing(int(ld_a), int(ld_b))


# ------------------------------------------------------------- plan mgmt

@_catch
def bsrsv_create_plan(
    handle: int,
    mb: int,
    rowptr_a, colind_a,
    rowptr_x, colind_x,
    rowptr_b, colind_b,
    index_offset: int = 0,
    echo: int = 0,
) -> tuple[int, int] | int:
    """tfqmrgpu_bsrsv_createPlan (tfqmrgpu.cu:136-351): the analysis step,
    on the handle's device.  Returns (status, plan_id)."""
    h = _HANDLES.get(int(handle))
    if h is None:
        return encode_status(Status.POINTER_INVALID)
    mb = int(mb)

    def as_i32(v):
        return np.ascontiguousarray(np.asarray(v, dtype=np.int32))

    a = Bsr(mb, mb, as_i32(rowptr_a), as_i32(colind_a), name="A")
    x = Bsr(mb, 0, as_i32(rowptr_x), as_i32(colind_x), name="X")
    b = Bsr(mb, 0, as_i32(rowptr_b), as_i32(colind_b), name="B")
    off = int(index_offset)
    x.ncols = int(x.colind.max(initial=off)) + 1 - off
    b.ncols = x.ncols
    plan = create_plan(a, x, b, index_offset=off, echo=int(echo),
                       device=h.device)
    pid = next(_ids)
    _PLANS[pid] = _PlanState(plan=plan, echo=int(echo),
                             bsr_a=a, bsr_x=x, bsr_b=b)
    return SUCCESS, pid


def bsrsv_destroy_plan(handle: int, plan: int) -> int:
    del handle
    if _PLANS.pop(int(plan), None) is None:
        return encode_status(Status.POINTER_INVALID)
    return SUCCESS


@_catch
def bsrsv_buffer_size(
    handle: int,
    plan: int,
    ld_a: int,
    block_dim: int,
    ld_b: int,
    rhs_block_dim: int,
    precision: str,
) -> tuple[int, int] | int:
    """tfqmrgpu_bsrsv_bufferSize (tfqmrgpu.cu:364-412): attach block-shape and
    precision info to the plan; return the device-memory estimate in bytes."""
    del handle
    ps = _PLANS[int(plan)]
    precision = _char(precision)
    if precision not in ("c", "z", "m"):
        return encode_status(Status.PRECISION_MISSMATCH, 0, precision)
    lm, ln = int(block_dim), int(rhs_block_dim)
    if int(ld_a) != lm or int(ld_b) != ln:
        # blocks are stored unpadded; ld must equal the dim
        return encode_status(Status.UNDOCUMENTED_ERROR, 1)
    if ln < lm or lm < 1:
        return encode_status(Status.BLOCKSIZE_MISSING, 0)
    ps.lm, ps.ln, ps.precision = lm, ln, precision
    ps.plan.lm, ps.plan.ln, ps.plan.precision = lm, ln, precision
    # 'm' iterates in 'c' and refines in 'z'; report the 'z' (upper-bound)
    # footprint so callers allocating by this number are always safe
    est = "z" if precision in ("z", "m") else "c"
    return SUCCESS, ps.plan.memory_requirement_bytes(lm, ln, est)


@_catch
def bsrsv_set_buffer(handle: int, plan: int, buffer_token: int = 1) -> int:
    """tfqmrgpu_bsrsv_setBuffer (tfqmrgpu.cu:415-450): performs the state
    setup the reference does here -- draws the shadow vector v3, builds the
    engine (``Solver``) on the plan's device and ships the index tables
    there."""
    del handle
    ps = _PLANS[int(plan)]
    if ps.lm == 0:
        return encode_status(Status.NO_INFO_PASSED, 1)
    # 'm' (mixed) iterates in 'c'; its 'z' fallback solver is built at
    # solve time from the recorded host matrices
    iter_prec = "c" if ps.precision == "m" else ps.precision
    ps.solver = Solver(ps.bsr_a, ps.bsr_x, ps.bsr_b, precision=iter_prec,
                       echo=ps.echo, lm=ps.lm, ln=ps.ln, plan=ps.plan,
                       device=ps.plan.device)
    # the solver keeps its own copy of the plan and writes the statistics
    # of each solve there, which is where getInfo reads them
    ps.plan = ps.solver.plan
    ps.x_refined = None
    ps.buffer_token = int(buffer_token) or 1
    for var, args in ps.pending.items():
        ps.solver.set_matrix(var, *args[:-1], **args[-1])
    ps.pending.clear()
    return SUCCESS


def bsrsv_get_buffer(handle: int, plan: int) -> tuple[int, int]:
    del handle
    ps = _PLANS.get(int(plan))
    if ps is None:
        return encode_status(Status.POINTER_INVALID), 0
    return SUCCESS, ps.buffer_token


# ------------------------------------------------------------- matrix I/O

def _precision_ok(ps: _PlanState, precision: str) -> bool:
    """'?' or the plan's precision; an 'm' plan also takes 'z' and 'c'."""
    return precision in ("?", ps.precision) + (
        ("z", "c") if ps.precision == "m" else ())


@_catch
def bsrsv_set_matrix(
    handle: int,
    plan: int,
    var: str,
    val,
    precision: str = "?",
    ld: int = 0,
    d2: int = 0,
    trans: str = "n",
    layout: int = layout_ops.LAYOUT_RIRIRIRI,
) -> int:
    """tfqmrgpu_bsrsv_setMatrix (tfqmrgpu.cu:609-621).  ``val`` is a real
    array in the given layout or a complex [nnzb, ld, d2] array."""
    del handle, ld, d2
    ps = _PLANS[int(plan)]
    var, trans, precision = _char(var), _char(trans), _char(precision)
    if not _precision_ok(ps, precision):
        return encode_status(Status.PRECISION_MISSMATCH, 2, precision)
    args = (val, {"trans": trans, "layout": layout})
    ps.raw[var.upper()] = args      # kept for the 'm' refine stage
    if ps.solver is None:
        ps.pending[var.upper()] = args
        return SUCCESS
    ps.solver.set_matrix(var, *args[:-1], **args[-1])
    return SUCCESS


@_catch
def bsrsv_get_matrix(
    handle: int,
    plan: int,
    var: str = "X",
    precision: str = "?",
    ld: int = 0,
    d2: int = 0,
    trans: str = "n",
    layout: int = layout_ops.LAYOUT_RIRIRIRI,
) -> tuple[int, np.ndarray] | int:
    """tfqmrgpu_bsrsv_getMatrix (tfqmrgpu.cu:624-645), restricted to 'X'."""
    del handle, ld, d2
    ps = _PLANS[int(plan)]
    var, trans, precision = _char(var), _char(trans), _char(precision)
    if ps.solver is None:
        return encode_status(Status.NO_INFO_PASSED, 3)
    if not _precision_ok(ps, precision):
        return encode_status(Status.PRECISION_MISSMATCH, 4, precision)
    if ps.x_refined is not None:
        if var.upper() != "X":
            return encode_status(Status.VARIABLENAME_UNKNOWN, 0, var)
        xm = ps.x_refined
        return SUCCESS, layout_ops.from_planes(xm.real, xm.imag, trans=trans,
                                               layout=layout)
    return SUCCESS, ps.solver.get_matrix(var, trans=trans, layout=layout)


# ------------------------------------------------------------------ solve

@_catch
def bsrsv_solve(handle: int, plan: int, threshold: float = 1e-6,
                max_iterations: int = 999) -> int:
    """tfqmrgpu_bsrsv_solve (tfqmrgpu.cu:648-661)."""
    del handle
    ps = _PLANS[int(plan)]
    if ps.solver is None:
        return encode_status(Status.NO_INFO_PASSED, 5)
    ps.x_refined = None
    if ps.precision == "m":
        return _solve_mixed_plan(ps, float(threshold), int(max_iterations))
    info = ps.solver.solve(tolerance=float(threshold),
                           max_iterations=int(max_iterations))
    return int(info.return_status)


def _solve_mixed_plan(ps: _PlanState, threshold: float,
                      max_iterations: int) -> int:
    """The mixed-precision path through the plan API (``mixed_stages``):
    iterate in 'c', then reach float64 residuals by iterative refinement
    (one float64 pair-plan product per round, K1 on the card, and float32
    correction solves), with a complex128 re-solve if refinement stalls.
    getMatrix returns the X this leaves in ``ps.x_refined``."""
    a_args = ps.raw.get("A")
    b_args = ps.raw.get("B")
    if a_args is None or b_args is None:
        return encode_status(Status.NO_INFO_PASSED, 6)
    # float64 planes of the recorded host matrices for the residual
    a_re64, a_im64 = layout_ops.to_planes(
        a_args[0], ps.plan.nnzb_a, ps.lm, ps.lm, dtype=np.float64,
        **a_args[-1])
    b_re64, b_im64 = layout_ops.to_planes(
        b_args[0], ps.plan.nnzb_b, ps.lm, ps.ln, dtype=np.float64,
        **b_args[-1])
    bx64 = _scatter_to_x(ps.plan, b_re64 + 1j * b_im64, ps.lm, ps.ln)

    def make_z():
        # its v3 is the seeded draw the 'c' Solver made
        sz = Solver(ps.bsr_a, ps.bsr_x, ps.bsr_b, precision="z",
                    echo=ps.echo, lm=ps.lm, ln=ps.ln, plan=ps.plan,
                    device=ps.plan.device)
        for var, args in ps.raw.items():
            sz.set_matrix(var, *args[:-1], **args[-1])
        return sz

    ps.x_refined, info = mixed_stages(
        ps.solver, a_re64, a_im64, bx64, tolerance=threshold,
        max_iterations=max_iterations, c_tolerance=1e-4, make_z=make_z,
        echo=ps.echo)
    # fold the stages into the plan's statistics (getInfo reads ps.plan)
    ps.plan.residuum_reached = info.residuum_reached
    ps.plan.iterations_needed = info.iterations_needed
    ps.plan.flops_performed = info.flops_performed
    return int(info.return_status)


def bsrsv_get_info(handle: int, plan: int) -> tuple[int, float, int, float, float]:
    """tfqmrgpu_bsrsv_getInfo (tfqmrgpu.cu:663-679) ->
    (status, residuum, iterations, flops, flops_all)."""
    del handle
    ps = _PLANS.get(int(plan))
    if ps is None:
        return encode_status(Status.POINTER_INVALID), -1.0, -1, -1.0, -1.0
    p = ps.plan
    return (SUCCESS, p.residuum_reached, p.iterations_needed,
            p.flops_performed, p.flops_performed_all)


# --------------------------------------------------- one-call convenience

def _bsrsv_onecall(precision: str, mb, ld_a, ld_b,
                   rowptr_a, colind_a, amat, trans_a,
                   rowptr_x, colind_x, xmat, trans_x,
                   rowptr_b, colind_b, bmat, trans_b,
                   max_iterations, threshold, index_offset, echo,
                   device=None):
    """The full 10-step sequence (reference: tfqmrgpu::tfqmrgpu_bsrsv,
    tfqmrgpu.cu:700-791) on ``device`` (the CUDA card unless given).
    Returns (status, X, iterations, residual)."""
    del xmat
    st, h = create_handle(device)
    if st:
        return st, None, 0, 0.0
    try:
        out = bsrsv_create_plan(h, mb, rowptr_a, colind_a, rowptr_x, colind_x,
                                rowptr_b, colind_b, index_offset, echo)
        if isinstance(out, int):
            return out, None, 0, 0.0
        st, p = out
        try:
            out = bsrsv_buffer_size(h, p, ld_a, ld_a, ld_b, ld_b, precision)
            if isinstance(out, int):
                return out, None, 0, 0.0
            st = bsrsv_set_buffer(h, p)
            if st:
                return st, None, 0, 0.0
            st = bsrsv_set_matrix(h, p, "A", amat, precision,
                                  ld_a, ld_a, trans_a)
            if st:
                return st, None, 0, 0.0
            st = bsrsv_set_matrix(h, p, "B", bmat, precision,
                                  ld_a, ld_b, trans_b)
            if st:
                return st, None, 0, 0.0
            solve_st = bsrsv_solve(h, p, threshold, max_iterations)
            if solve_st not in (SUCCESS, int(Status.MAX_ITERATIONS)):
                return solve_st, None, 0, 0.0
            _, resid, iters, _, _ = bsrsv_get_info(h, p)
            out = bsrsv_get_matrix(h, p, "X", precision, ld_a, ld_b, trans_x)
            if isinstance(out, int):
                return out, None, iters, resid
            _, xval = out
            return solve_st, xval, iters, resid
        finally:
            bsrsv_destroy_plan(h, p)
    finally:
        destroy_handle(h)


def bsrsv_z(mb, ld_a, ld_b, rowptr_a, colind_a, amat, trans_a,
            rowptr_x, colind_x, xmat, trans_x,
            rowptr_b, colind_b, bmat, trans_b,
            max_iterations=999, threshold=1e-9, index_offset=0, echo=0,
            device=None):
    """tfqmrgpu_bsrsv_z (tfqmrgpu.cu:796-809): complex128 one-call solve on
    RIRIRIRI-interleaved double arrays.  Returns
    (status, X_riri, iterations, residual)."""
    return _bsrsv_onecall("z", mb, ld_a, ld_b,
                          rowptr_a, colind_a, amat, trans_a,
                          rowptr_x, colind_x, xmat, trans_x,
                          rowptr_b, colind_b, bmat, trans_b,
                          max_iterations, threshold, index_offset, echo,
                          device)


def bsrsv_c(mb, ld_a, ld_b, rowptr_a, colind_a, amat, trans_a,
            rowptr_x, colind_x, xmat, trans_x,
            rowptr_b, colind_b, bmat, trans_b,
            max_iterations=999, threshold=1e-5, index_offset=0, echo=0,
            device=None):
    """tfqmrgpu_bsrsv_c (tfqmrgpu.cu:812-822): complex64 one-call solve."""
    return _bsrsv_onecall("c", mb, ld_a, ld_b,
                          rowptr_a, colind_a, amat, trans_a,
                          rowptr_x, colind_x, xmat, trans_x,
                          rowptr_b, colind_b, bmat, trans_b,
                          max_iterations, threshold, index_offset, echo,
                          device)


def bsrsv_m(mb, ld_a, ld_b, rowptr_a, colind_a, amat, trans_a,
            rowptr_x, colind_x, xmat, trans_x,
            rowptr_b, colind_b, bmat, trans_b,
            max_iterations=999, threshold=1e-9, index_offset=0, echo=0,
            device=None):
    """Mixed-precision one-call solve on double (RIRIRIRI) arrays:
    complex64 iterations + float64-residual refinement.  The mode the
    reference declares but never enabled (tfqmrgpu.cu:42)."""
    return _bsrsv_onecall("m", mb, ld_a, ld_b,
                          rowptr_a, colind_a, amat, trans_a,
                          rowptr_x, colind_x, xmat, trans_x,
                          rowptr_b, colind_b, bmat, trans_b,
                          max_iterations, threshold, index_offset, echo,
                          device)

"""The tfQMR iteration.

Transcribes the reference's ``tfqmrgpu::solve`` (tfqmrgpu_core.hxx:20-335),
as ``tfqmrgpu_tpu/core.py`` does, into a Python loop over torch tensors:
seven X-shaped work vectors, per-RHS complex scalar recurrences (rho, alfa,
beta, c67, eta) and real ones (tau, var), a float32 random shadow vector
v3, and the adaptive convergence control that bounds the residual cheaply
every iteration (tau-based upper bound, tfqmrgpu_core.hxx:235-253) and
probes the true residual ``|A@v1 - B|`` only when the bound crosses an
adaptive target (tfqmrgpu_core.hxx:263-304).

As in the reference, the convergence decision is taken on the host every
iteration (tfqmrgpu_core.hxx:235-236): one small device-to-host read per
iteration, and one more per probe.  The JAX package keeps the whole loop on
the device instead; the carry, the probe logic and the numbers are the same.

Iteration body (tfqmrgpu_core.hxx:179-306, two half-steps):

    z35 = <v3, v5>;  dec35 -> beta, rho
    v6 = v5 + beta*v6;  v4 = v8 + beta*v4
    v9 = A @ v6;        v4 = v9 + beta*v4
    z34 = <v3, v4>;  dec34 -> c67, alfa
    v7 = v6 + c67*v7;   v5 += alfa*v9
    d55 = |v5|^2;    decT -> c67(real), eta, var, tau
    v1 += eta*v7;       v6 += alfa*v4;   v7 = v6 + c67*v7
    v8 = A @ v6;        v5 += alfa*v8
    d55 = |v5|^2;    decT -> eta, var, tau
    v1 += eta*v7
    convergence control (bound check, optional residual probe)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .errors import Status
from .ops import decisions, linalg
from .ops.blocksparse import flops_spmm

Pair = tuple

RANDOM_SEED = 1234  # reference: fixed cuRAND seed (tfqmrgpu_linalg.hxx:793)


class SolveResult(NamedTuple):
    x: Pair                      # solution blocks ([nnzbX, LM, LN] re, im)
    return_status: int           # SUCCESS / MAX_ITERATIONS / BREAKDOWN
    iterations: int              # iterations needed
    residuum: float              # sqrt(max residual^2 reached)
    rhs_status: torch.Tensor     # int32[nCols, LN] per-RHS status
    n_probes: int                # true-residual probes (one multiply each)
    tau: torch.Tensor            # f64[nCols, LN] final squared-norm recurrence


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclasses.dataclass(frozen=True)
class TfqmrPrimitives:
    """The operations the loop body needs, bound to the plan's tables.

    ``allmax`` and ``alland`` reduce a host-decision scalar (a float64 max,
    a bool "all") over the other ranks of a sharded solve before the host
    reads it (``parallel/``); on one device they are the identity."""

    multiply: Callable[[Pair], Pair]          # y = A @ x
    dotp: Callable[[Pair, Pair], Pair]        # per-column <x, y>  (f64)
    nrm2: Callable[[Pair], torch.Tensor]      # per-column |x|^2   (f64)
    axpy: Callable[[Pair, Pair, Pair], Pair]  # y + a[col]*x
    xpay: Callable[[Pair, Pair, Pair], Pair]  # x + a[col]*y   (y, a, x)
    add_rhs: Callable[[Pair, Pair, float], Pair]
    allmax: Callable[[torch.Tensor], torch.Tensor] = _identity
    alland: Callable[[torch.Tensor], torch.Tensor] = _identity


def make_shadow_vector(nnzb_x: int, lm: int, ln: int, *, device,
                       seed: int = RANDOM_SEED) -> Pair:
    """The random shadow vector v3: uniform float32 from a seeded generator
    (reference: create_random_numbers, tfqmrgpu_linalg.hxx:777-806).  The
    numbers are drawn on a CPU generator, so that every device gets the
    same v3, and then moved to ``device``.  ``jax.random`` numbers cannot
    be reproduced here; to compare with the JAX package, hand its v3 to the
    solver instead."""
    generator = torch.Generator().manual_seed(seed)
    v = torch.rand((2, nnzb_x, lm, ln), generator=generator,
                   dtype=torch.float32)
    return v[0].to(device), v[1].to(device)


def inverse_norms(n2: torch.Tensor) -> torch.Tensor:
    """1/n2 where n2 > 0, else 0: the convergence normalization of the
    squared column norms of B (an empty column never converges)."""
    return torch.where(n2 > 0, 1.0 / torch.where(n2 > 0, n2, 1.0), 0.0)


def tfqmr_loop(prim: TfqmrPrimitives, v2: Pair, v3: Pair, v5_init: Pair,
               tau0: torch.Tensor, inv_bn2: torch.Tensor, tolerance: float,
               max_iterations: int, dt) -> SolveResult:
    """The tfQMR loop over the primitive set."""
    f64 = torch.float64
    tol2 = float(tolerance) ** 2
    maxit = int(max_iterations)
    ncols, ln = tau0.shape
    dev = tau0.device

    def czeros():
        # vectors are (re, im) pairs, or single fused tensors (packed pairs)
        if torch.is_tensor(v5_init):
            return torch.zeros_like(v5_init)
        return torch.zeros_like(v5_init[0]), torch.zeros_like(v5_init[1])

    def szeros(dtype=dt):
        return torch.zeros((ncols, ln), dtype=dtype, device=dev)

    v1, v4, v6, v7, v8 = czeros(), czeros(), czeros(), czeros(), czeros()
    v5 = v5_init
    rho = (torch.ones((ncols, ln), dtype=dt, device=dev), szeros())
    eta = (szeros(), szeros())
    tau = tau0
    var = szeros(f64)
    status = szeros(torch.int32)
    target_bound2 = tol2 * 100.0 * 100.0     # init test_factor=100 (:130)
    residual2 = 1e30
    stop_code = 0                            # 0 running, 1 converged, 2 breakdown
    iters_needed = maxit
    n_probes = 0
    it = 0

    while it < maxit and stop_code == 0:
        it += 1
        # ---- first half-step
        z35 = prim.dotp(v3, v5)                            # <v3, v5>
        status, rho, beta = decisions.dec35(status, rho, z35, dt)
        v6 = prim.xpay(v6, beta, v5)                       # v6 := v5 + beta*v6
        v4 = prim.xpay(v4, beta, v8)                       # v4 := v8 + beta*v4
        v9 = prim.multiply(v6)                             # v9 := A @ v6
        v4 = prim.xpay(v4, beta, v9)                       # v4 := v9 + beta*v4
        z34 = prim.dotp(v3, v4)                            # <v3, v4>
        status, c67, alfa = decisions.dec34(status, rho, eta, z34, var, dt)
        v7 = prim.xpay(v7, c67, v6)                        # v7 := v6 + c67*v7
        v5 = prim.axpy(v5, v9, alfa)                       # v5 += alfa*v9
        d55 = prim.nrm2(v5)
        status, c67, eta, var, tau = decisions.dect(
            status, var, tau, alfa, d55, dt, with_c67=True)
        v1 = prim.axpy(v1, v7, eta)                        # v1 += eta*v7
        v6 = prim.axpy(v6, v4, alfa)                       # v6 += alfa*v4
        v7 = prim.xpay(v7, c67, v6)                        # v7 := v6 + c67*v7
        # ---- second half-step
        v8 = prim.multiply(v6)                             # v8 := A @ v6
        v5 = prim.axpy(v5, v8, alfa)                       # v5 += alfa*v8
        d55 = prim.nrm2(v5)
        status, _, eta, var, tau = decisions.dect(
            status, var, tau, alfa, d55, dt, with_c67=False)
        v1 = prim.axpy(v1, v7, eta)                        # v1 += eta*v7

        # ---- convergence control on the host (tfqmrgpu_core.hxx:235-304)
        broke = (status == -1) | (status == -2)
        max_ub, all_broke = torch.stack(
            [prim.allmax((tau * inv_bn2).max()),
             prim.alland(broke.all()).to(f64)]).tolist()
        max_bound2 = max_ub * float(2 * it + 1)
        if all_broke:
            stop_code = 2
        elif max_bound2 <= target_bound2 or it >= maxit:
            y = prim.multiply(v1)                          # v9 := A @ v1
            y = prim.add_rhs(y, v2, -1.0)                  # v9 -= B
            res2 = prim.nrm2(y) * inv_bn2
            # isDone is evaluated with the status BEFORE the res2 <= 0
            # update, as in the reference's loop (tfqmrgpu_core.hxx:276-286)
            done = prim.alland(((res2 <= tol2) | (status != 0)).all())
            status = torch.where(res2 <= 0, torch.ones_like(status), status)
            max_res2, is_done = torch.stack(
                [prim.allmax(res2.max()), done.to(f64)]).tolist()
            # underflow guard (1.4e-76 in the reference)
            residual2 = max(max_res2, decisions.EPSILON)
            target_bound2 = (max_bound2 / residual2) * tol2
            n_probes += 1
            if is_done:
                stop_code = 1
                iters_needed = it

    return_status = {1: Status.SUCCESS, 2: Status.BREAKDOWN}.get(
        stop_code, Status.MAX_ITERATIONS)
    return SolveResult(x=v1, return_status=int(return_status),
                       iterations=iters_needed, residuum=residual2 ** 0.5,
                       rhs_status=status, n_probes=n_probes, tau=tau)


def solve_core(multiply: Callable[[Pair], Pair], v2: Pair, v3: Pair,
               cols: linalg.Columns, subset: torch.Tensor, tolerance: float,
               max_iterations: int, inv_bn2_override=None, *, lm: int,
               ln: int, rhs_trivial: bool = False) -> SolveResult:
    """Prepare the right-hand side and its norms, then run the loop
    (tfqmrgpu_core.hxx:114-168).  ``v2`` holds B's blocks [nnzbB, LM, LN]
    (a shape placeholder when ``rhs_trivial``); ``subset`` maps them into
    X's blocks."""
    dt = v2[0].dtype
    dev = v2[0].device
    colindx = cols.colindx
    prim = TfqmrPrimitives(
        multiply=multiply,
        dotp=lambda x, y: linalg.dotp(x, y, cols),
        nrm2=lambda x: linalg.nrm2(x, cols),
        axpy=lambda y, x, a: linalg.axpy(y, x, a, colindx),
        xpay=lambda y, a, x: linalg.xpay(y, a, x, colindx),
        add_rhs=lambda v, b, s: linalg.add_rhs(v, b, s, subset),
    )
    z = torch.zeros((int(colindx.shape[0]), lm, ln), dtype=dt, device=dev)
    if rhs_trivial:
        v2 = linalg.set_unit_blocks(int(subset.shape[0]), lm, ln, dt, dev)
        v5 = prim.add_rhs((z, z), v2, 1.0)
        tau0 = torch.ones((cols.ncols, ln), dtype=torch.float64, device=dev)
        inv_bn2 = tau0
    else:
        v5 = prim.add_rhs((z, z), v2, 1.0)
        tau0 = prim.nrm2(v5)                 # squared column norms of B
        inv_bn2 = inverse_norms(tau0)
    if inv_bn2_override is not None:
        inv_bn2 = inv_bn2_override
    return tfqmr_loop(prim, v2, v3, v5, tau0, inv_bn2, tolerance,
                      max_iterations, dt)


def solve_core_panel(multiply: Callable[[Pair], Pair], b_panel: Pair,
                     v3_panel: Pair, tolerance: float, max_iterations: int,
                     inv_bn2_override=None, *,
                     rhs_trivial: bool = False) -> SolveResult:
    """The panel engines' entry (JAX: core.solve_core_panel): vectors live
    as [NR, ncc, LN] panels (``ops/panel.py``); ``multiply`` returns masked
    panels and ``b_panel`` holds B (the unit blocks when ``rhs_trivial``)."""
    from .ops.panel import make_panel_primitives

    prim = make_panel_primitives(multiply, b_panel)
    v5 = (b_panel[0], b_panel[1])
    _, ncc, ln = b_panel[0].shape
    if rhs_trivial:
        tau0 = torch.ones((ncc, ln), dtype=torch.float64,
                          device=b_panel[0].device)
        inv_bn2 = tau0
    else:
        tau0 = prim.nrm2(v5)                 # squared column norms of B
        inv_bn2 = inverse_norms(tau0)
    if inv_bn2_override is not None:
        inv_bn2 = inv_bn2_override
    return tfqmr_loop(prim, b_panel, v3_panel, v5, tau0, inv_bn2, tolerance,
                      max_iterations, b_panel[0].dtype)


def solve_core_fused(prim: TfqmrPrimitives, b_fused: torch.Tensor,
                     v3_fused: torch.Tensor, ncols: int, ln: int,
                     tolerance: float, max_iterations: int,
                     inv_bn2_override=None, *,
                     rhs_trivial: bool = False) -> SolveResult:
    """The packed pairs engine's entry (JAX: the step of its solver's
    ``_solve_pairs``): vectors are fused permuted panels
    (``ops/pairpanel.fused_primitives``, whose ``add_rhs`` holds
    ``b_fused``: B, or the unit blocks when ``rhs_trivial``)."""
    v5 = prim.add_rhs(torch.zeros_like(b_fused), b_fused, 1.0)
    if rhs_trivial:
        tau0 = torch.ones((ncols, ln), dtype=torch.float64,
                          device=b_fused.device)
        inv_bn2 = tau0
    else:
        tau0 = prim.nrm2(v5)                 # squared column norms of B
        inv_bn2 = inverse_norms(tau0)
    if inv_bn2_override is not None:
        inv_bn2 = inv_bn2_override
    return tfqmr_loop(prim, b_fused, v3_fused, v5, tau0, inv_bn2, tolerance,
                      max_iterations, b_fused.dtype)


def flops_per_iteration(n_pairs: int, nnzb_x: int, lm: int, ln: int) -> float:
    """Flops of one iteration (2 SpMM + 2 dotp + 2 nrm2 + 10 axpy/xpay),
    by the reference's accounting (tfqmrgpu_core.hxx:133-138)."""
    return (2 * flops_spmm(n_pairs, lm, ln)
            + 2 * linalg.flops_dotp(nnzb_x, lm, ln)
            + 2 * linalg.flops_nrm2(nnzb_x, lm, ln)
            + 10 * linalg.flops_axpy(nnzb_x, lm, ln))


def flops_per_probe(n_pairs: int, nnzb_x: int, lm: int, ln: int) -> float:
    return flops_spmm(n_pairs, lm, ln) + linalg.flops_nrm2(nnzb_x, lm, ln)

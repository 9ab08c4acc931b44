"""The tfQMR iteration.

Transcribes the reference's ``tfqmrgpu::solve`` (tfqmrgpu_core.hxx:20-335),
as ``tfqmrgpu_tpu/core.py`` does, into a Python loop over torch tensors:
seven X-shaped work vectors, per-RHS complex scalar recurrences (rho, alfa,
beta, c67, eta) and real ones (tau, var), a float32 random shadow vector
v3, and the adaptive convergence control that bounds the residual cheaply
every iteration (tau-based upper bound, tfqmrgpu_core.hxx:235-253) and
probes the true residual ``|A@v1 - B|`` only when the bound crosses an
adaptive target (tfqmrgpu_core.hxx:263-304).

The loop is written in carry form, as the JAX package's: ``init_carry``,
then per iteration ``step`` (the two half-steps), ``decide`` (the bound and
the probe predicate) and, where ``decide`` says so, ``probe_residual`` and
``settle`` (JAX's ``do_probe``).  The reference takes the convergence
decision on the host every iteration (tfqmrgpu_core.hxx:235-236).  Here, on
a CUDA device, the whole loop is one launch of one CUDA graph
(``graphloop.py``): a WHILE node around the iteration and an IF node around
the probe, whose predicates the kernels of ``csrc/loop_control.cu`` set on
the card, so the host reads the loop's state once, after the loop, as the
JAX package's ``jax.lax.while_loop`` does; a sharded solve's graph holds
its collectives too (``parallel/``).  On the CPU a plain Python driver runs
the same functions (``plain_loop``).

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
from typing import Any, Callable, NamedTuple

import torch

from .errors import Status
from .ops import decisions, linalg
from .ops.blocksparse import flops_spmm
from .profiling import trace

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


@dataclasses.dataclass(frozen=True)
class TfqmrPrimitives:
    """The operations the loop body needs, bound to the plan's tables.

    ``mesh`` is a sharded solve's ``parallel.sharded.Mesh``, None on one
    device: the decisions then take their scalars over every rank, each in
    two stages around one ``mesh.reduce_max`` of the rank's partials
    (``decide_local`` / ``decide_finish``, ``settle_local`` /
    ``settle_finish``), and the graph driver agrees with the other ranks
    on its capture (``mesh.agree``).

    ``axpy``, ``xpay`` and ``add_rhs`` may write their result into their
    first vector and return it (``linalg.VectorPasses`` does on the card):
    ``step`` never reads a vector again after the call that replaces it."""

    multiply: Callable[[Pair], Pair]          # y = A @ x
    dotp: Callable[[Pair, Pair], Pair]        # per-column <x, y>  (f64)
    nrm2: Callable[[Pair], torch.Tensor]      # per-column |x|^2   (f64)
    axpy: Callable[[Pair, Pair, Pair], Pair]  # y + a[col]*x
    xpay: Callable[[Pair, Pair, Pair], Pair]  # x + a[col]*y   (y, a, x)
    add_rhs: Callable[[Pair, Pair, float], Pair]
    mesh: Any = None


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


@dataclasses.dataclass
class Carry:
    """The loop state (JAX: ``core._Carry``): the X-shaped work vectors in
    the engine's layout, the per-RHS fields [ncols, LN], and the loop's
    scalars as 0-d tensors on the vectors' device, so that the decisions
    can be taken there: ``it``, ``stop_code`` (0 running, 1 converged, 2
    breakdown), ``iters_needed`` and ``n_probes`` int32, ``target_bound2``
    and ``residual2`` float64."""

    it: torch.Tensor
    v1: Any
    v4: Any
    v5: Any
    v6: Any
    v7: Any
    v8: Any
    rho: Pair
    eta: Pair
    tau: torch.Tensor
    var: torch.Tensor
    status: torch.Tensor
    target_bound2: torch.Tensor
    residual2: torch.Tensor
    stop_code: torch.Tensor
    iters_needed: torch.Tensor
    n_probes: torch.Tensor


def _tree(fn, v):
    """``fn`` over a vector: an (re, im) pair or one fused tensor."""
    return fn(v) if torch.is_tensor(v) else tuple(fn(t) for t in v)


def init_carry(v5_init, tau0: torch.Tensor, tol2: torch.Tensor,
               maxit: torch.Tensor, dt) -> Carry:
    """The state before the first iteration (tfqmrgpu_core.hxx:114-130),
    from the loop's inputs: ``tol2`` (float64) and ``maxit`` (int32) are
    0-d tensors.  The carry holds copies of ``v5_init``, ``tau0`` and
    ``maxit``, so that the inputs stay as they were."""
    ncols, ln = tau0.shape
    dev = tau0.device

    def szeros(dtype=dt):
        return torch.zeros((ncols, ln), dtype=dtype, device=dev)

    def scalar(value, dtype):
        return torch.full((), value, dtype=dtype, device=dev)

    return Carry(
        it=scalar(0, torch.int32),
        v1=_tree(torch.zeros_like, v5_init),
        v4=_tree(torch.zeros_like, v5_init),
        v5=_tree(torch.clone, v5_init),
        v6=_tree(torch.zeros_like, v5_init),
        v7=_tree(torch.zeros_like, v5_init),
        v8=_tree(torch.zeros_like, v5_init),
        rho=(torch.ones((ncols, ln), dtype=dt, device=dev), szeros()),
        eta=(szeros(), szeros()),
        tau=tau0.clone(),
        var=szeros(torch.float64),
        status=szeros(torch.int32),
        target_bound2=tol2 * 100.0 * 100.0,  # init test_factor=100 (:130)
        residual2=scalar(1e30, torch.float64),
        stop_code=scalar(0, torch.int32),
        iters_needed=maxit.clone(),
        n_probes=scalar(0, torch.int32),
    )


def step(prim: TfqmrPrimitives, c: Carry, v3: Pair, dt) -> Carry:
    """One iteration's two half-steps (tfqmrgpu_core.hxx:179-233): the
    carry with ``it`` + 1 and new vectors and per-RHS fields."""
    # ---- first half-step
    z35 = prim.dotp(v3, c.v5)                              # <v3, v5>
    status, rho, beta = decisions.dec35(c.status, c.rho, z35, dt)
    v6 = prim.xpay(c.v6, beta, c.v5)                       # v6 := v5 + beta*v6
    v4 = prim.xpay(c.v4, beta, c.v8)                       # v4 := v8 + beta*v4
    v9 = prim.multiply(v6)                                 # v9 := A @ v6
    v4 = prim.xpay(v4, beta, v9)                           # v4 := v9 + beta*v4
    z34 = prim.dotp(v3, v4)                                # <v3, v4>
    status, c67, alfa = decisions.dec34(status, rho, c.eta, z34, c.var, dt)
    v7 = prim.xpay(c.v7, c67, v6)                          # v7 := v6 + c67*v7
    v5 = prim.axpy(c.v5, v9, alfa)                         # v5 += alfa*v9
    d55 = prim.nrm2(v5)
    status, c67, eta, var, tau = decisions.dect(
        status, c.var, c.tau, alfa, d55, dt, with_c67=True)
    v1 = prim.axpy(c.v1, v7, eta)                          # v1 += eta*v7
    v6 = prim.axpy(v6, v4, alfa)                           # v6 += alfa*v4
    v7 = prim.xpay(v7, c67, v6)                            # v7 := v6 + c67*v7
    # ---- second half-step
    v8 = prim.multiply(v6)                                 # v8 := A @ v6
    v5 = prim.axpy(v5, v8, alfa)                           # v5 += alfa*v8
    d55 = prim.nrm2(v5)
    status, _, eta, var, tau = decisions.dect(
        status, var, tau, alfa, d55, dt, with_c67=False)
    v1 = prim.axpy(v1, v7, eta)                            # v1 += eta*v7
    return dataclasses.replace(c, it=c.it + 1, v1=v1, v4=v4, v5=v5, v6=v6,
                               v7=v7, v8=v8, rho=rho, eta=eta, tau=tau,
                               var=var, status=status)


def decide(c: Carry, inv_bn2: torch.Tensor, maxit: torch.Tensor) -> tuple:
    """The convergence control after an iteration (tfqmrgpu_core.hxx:
    235-263; JAX: core.py:188-193): the residual bound max(tau * inv_bn2)
    * (2 it + 1), the probe predicate (bound at or below the target, or the
    iteration cap) unless every RHS broke down, which stops the loop.
    Returns (stop_code, max_bound2, probe) as 0-d tensors.  The plain
    version of ``graphloop.LoopControl.decide``."""
    max_ub = (c.tau * inv_bn2).max()
    max_bound2 = max_ub * (2 * c.it + 1).to(torch.float64)
    broke = (c.status == -1) | (c.status == -2)
    all_broke = broke.all()
    probe = (((max_bound2 <= c.target_bound2) | (c.it >= maxit))
             & ~all_broke)
    stop_code = torch.where(all_broke, 2, c.stop_code)
    return stop_code, max_bound2, probe


def decision_partials(m: torch.Tensor, flag: torch.Tensor,
                      keep_nan: bool) -> torch.Tensor:
    """A rank's partials of a decision, float64 [the max, -1 where the
    flag holds else 0], so that one MAX over the ranks reduces both.  The
    max over more than one rank follows JAX's pmax: a NaN is dropped (sent
    as -inf; -0 as +0, so that no order of the ranks picks the sign); on a
    mesh of one rank (``keep_nan``) the max goes as it is, as pmax over one
    device is the identity.  The plain version of the local stages of
    ``csrc/loop_control.cu``."""
    f64 = torch.float64
    if not keep_nan:
        m = torch.where(m.isnan(), float("-inf"), m + 0.0)
    return torch.stack([m.to(f64), torch.where(
        flag, torch.tensor(-1.0, dtype=f64, device=m.device),
        torch.tensor(0.0, dtype=f64, device=m.device))])


def decide_local(c: Carry, inv_bn2: torch.Tensor,
                 keep_nan: bool) -> torch.Tensor:
    """``decide``'s partials on this rank: the max of tau * inv_bn2 and
    whether every RHS broke down (``decision_partials``)."""
    broke = (c.status == -1) | (c.status == -2)
    return decision_partials((c.tau * inv_bn2).max(), broke.all(), keep_nan)


def decide_finish(c: Carry, part: torch.Tensor, maxit: torch.Tensor) -> tuple:
    """``decide`` from the partials reduced over the ranks (the max over
    every rank, the flag on every rank): (stop_code, max_bound2, probe).
    On one rank ``decide_finish(c, decide_local(c, inv_bn2, True), maxit)``
    equals ``decide``."""
    max_bound2 = part[0] * (2 * c.it + 1).to(torch.float64)
    all_broke = part[1] < 0
    probe = (((max_bound2 <= c.target_bound2) | (c.it >= maxit))
             & ~all_broke)
    stop_code = torch.where(all_broke, 2, c.stop_code)
    return stop_code, max_bound2, probe


def settle_local(c: Carry, res2: torch.Tensor, tol2: torch.Tensor,
                 keep_nan: bool) -> tuple:
    """``settle``'s stage on this rank: (the status after the res2 <= 0
    update, the partials of the max of res2 and of isDone, taken with the
    status before the update)."""
    is_done = ((res2 <= tol2) | (c.status != 0)).all()
    status = torch.where(res2 <= 0, torch.ones_like(c.status), c.status)
    return status, decision_partials(res2.max(), is_done, keep_nan)


def settle_finish(c: Carry, status: torch.Tensor, part: torch.Tensor,
                  max_bound2: torch.Tensor, tol2: torch.Tensor) -> Carry:
    """``settle`` from ``settle_local``'s status and the partials reduced
    over the ranks."""
    is_done = part[1] < 0
    residual2 = part[0].clamp_min(decisions.EPSILON)
    return dataclasses.replace(
        c, status=status, residual2=residual2,
        target_bound2=(max_bound2 / residual2) * tol2,
        stop_code=torch.where(is_done, 1, c.stop_code),
        iters_needed=torch.where(is_done, c.it, c.iters_needed),
        n_probes=c.n_probes + 1)


def probe_residual(prim: TfqmrPrimitives, c: Carry, v2: Pair,
                   inv_bn2: torch.Tensor) -> torch.Tensor:
    """The probe's true residual |A @ v1 - B|^2 / |B|^2 per RHS
    (tfqmrgpu_core.hxx:263-275): one multiply."""
    y = prim.multiply(c.v1)                                # v9 := A @ v1
    y = prim.add_rhs(y, v2, -1.0)                          # v9 -= B
    return prim.nrm2(y) * inv_bn2


def settle(c: Carry, res2: torch.Tensor, max_bound2: torch.Tensor,
           tol2: torch.Tensor) -> Carry:
    """What the probe decides (tfqmrgpu_core.hxx:276-304; JAX's
    ``do_probe``, core.py:195-211): isDone, the status of converged
    columns, the next target bound and the counters.  The plain version of
    ``graphloop.LoopControl.settle``."""
    # isDone is evaluated with the status BEFORE the res2 <= 0 update, as
    # in the reference's loop (tfqmrgpu_core.hxx:276-286)
    is_done = ((res2 <= tol2) | (c.status != 0)).all()
    status = torch.where(res2 <= 0, torch.ones_like(c.status), c.status)
    # underflow guard (1.4e-76 in the reference); clamp keeps a NaN
    residual2 = res2.max().clamp_min(decisions.EPSILON)
    return dataclasses.replace(
        c, status=status, residual2=residual2,
        target_bound2=(max_bound2 / residual2) * tol2,
        stop_code=torch.where(is_done, 1, c.stop_code),
        iters_needed=torch.where(is_done, c.it, c.iters_needed),
        n_probes=c.n_probes + 1)


def solve_result(c: Carry, stop_code: int, iters_needed: int, n_probes: int,
                 residual2: float) -> SolveResult:
    """The ``SolveResult`` of a final carry whose scalars the host read."""
    return_status = {1: Status.SUCCESS, 2: Status.BREAKDOWN}.get(
        int(stop_code), Status.MAX_ITERATIONS)
    return SolveResult(x=c.v1, return_status=int(return_status),
                       iterations=int(iters_needed),
                       residuum=float(residual2) ** 0.5,
                       rhs_status=c.status, n_probes=int(n_probes), tau=c.tau)


def plain_loop(prim: TfqmrPrimitives, v2: Pair, v3: Pair, v5_init: Pair,
               tau0: torch.Tensor, inv_bn2: torch.Tensor, tol2: float,
               maxit: int, dt) -> SolveResult:
    """The plain driver: a Python loop over ``step``, ``decide`` and, where
    it says so, ``probe_residual`` and ``settle``, reading the predicates
    on the host, one read an iteration and one a probe.  The CPU runs it
    (a sharded solve's decisions in their two stages around the mesh's
    ``reduce_max``, as the graph holds them), and ``chip_smoke.py`` holds
    the graph driver against it on the card."""
    dev = tau0.device
    tol2_t = torch.full((), tol2, dtype=torch.float64, device=dev)
    maxit_t = torch.full((), maxit, dtype=torch.int32, device=dev)
    mesh = prim.mesh
    c = init_carry(v5_init, tau0, tol2_t, maxit_t, dt)
    it, stop = 0, 0
    while it < maxit and stop == 0:
        c = step(prim, c, v3, dt)
        it += 1
        if mesh is None:
            stop_code, max_bound2, probe = decide(c, inv_bn2, maxit_t)
        else:
            part = mesh.reduce_max(decide_local(c, inv_bn2, mesh.ranks == 1))
            stop_code, max_bound2, probe = decide_finish(c, part, maxit_t)
        c.stop_code = stop_code
        go_probe, stop = torch.stack([probe.to(torch.int32),
                                      stop_code]).tolist()
        if go_probe:
            res2 = probe_residual(prim, c, v2, inv_bn2)
            if mesh is None:
                c = settle(c, res2, max_bound2, tol2_t)
            else:
                status, part = settle_local(c, res2, tol2_t, mesh.ranks == 1)
                c = settle_finish(c, status, mesh.reduce_max(part),
                                  max_bound2, tol2_t)
            stop = int(c.stop_code.item())
    iters_needed, n_probes, residual2 = torch.stack([
        c.iters_needed.to(torch.float64), c.n_probes.to(torch.float64),
        c.residual2]).tolist()
    return solve_result(c, stop, iters_needed, n_probes, residual2)


def tfqmr_loop(prim: TfqmrPrimitives, v2: Pair, v3: Pair, v5_init: Pair,
               tau0: torch.Tensor, inv_bn2: torch.Tensor, tolerance: float,
               max_iterations: int, dt, *, graphs=None,
               key: tuple = ()) -> SolveResult:
    """The tfQMR loop over the primitive set.  On a CUDA device the whole
    loop, the decisions to probe and to stop included, is one launch of a
    CUDA graph (``graphloop``): ``graphs`` (a ``graphloop.LoopGraphs``)
    keeps it under ``key`` for the next solve, and without it the graph is
    made for this solve alone.  On the CPU the plain driver runs the same
    functions (``plain_loop``)."""
    tol2 = float(tolerance) ** 2
    maxit = int(max_iterations)
    if tau0.device.type == "cpu":
        return plain_loop(prim, v2, v3, v5_init, tau0, inv_bn2, tol2, maxit,
                          dt)
    from .graphloop import run_graph

    return run_graph(graphs, key, prim, v2, v3, v5_init, tau0, inv_bn2, tol2,
                     maxit, dt)


def solve_core(multiply: Callable[[Pair], Pair], v2: Pair, v3: Pair,
               cols: linalg.Columns, subset: torch.Tensor, tolerance: float,
               max_iterations: int, inv_bn2_override=None, *, lm: int,
               ln: int, rhs_trivial: bool = False, graphs=None,
               key: tuple = ()) -> SolveResult:
    """Prepare the right-hand side and its norms, then run the loop
    (tfqmrgpu_core.hxx:114-168).  ``v2`` holds B's blocks [nnzbB, LM, LN]
    (a shape placeholder when ``rhs_trivial``); ``subset`` maps them into
    X's blocks.  ``graphs`` and ``key`` are ``tfqmr_loop``'s."""
    dt = v2[0].dtype
    dev = v2[0].device
    colindx = cols.colindx
    if dev.type == "cuda":
        # the kernels, in place: the loop graph copies none of their results
        vp = linalg.VectorPasses(cols, subset)
        prim = TfqmrPrimitives(multiply=multiply, dotp=vp.dotp,
                               nrm2=vp.nrm2, axpy=vp.axpy, xpay=vp.xpay,
                               add_rhs=vp.add_rhs)
    else:
        prim = TfqmrPrimitives(
            multiply=multiply,
            dotp=lambda x, y: linalg.dotp(x, y, cols),
            nrm2=lambda x: linalg.nrm2(x, cols),
            axpy=lambda y, x, a: linalg.axpy(y, x, a, colindx),
            xpay=lambda y, a, x: linalg.xpay(y, a, x, colindx),
            add_rhs=lambda v, b, s: linalg.add_rhs(v, b, s, subset),
        )
    with trace("prepare"):
        shape = (int(colindx.shape[0]), lm, ln)
        z = (torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
        if rhs_trivial:
            v2 = linalg.set_unit_blocks(int(subset.shape[0]), lm, ln, dt,
                                        dev)
            v5 = prim.add_rhs(z, v2, 1.0)
            tau0 = torch.ones((cols.ncols, ln), dtype=torch.float64,
                              device=dev)
            inv_bn2 = tau0
        else:
            v5 = prim.add_rhs(z, v2, 1.0)
            tau0 = prim.nrm2(v5)                 # squared column norms of B
            inv_bn2 = inverse_norms(tau0)
    if inv_bn2_override is not None:
        inv_bn2 = inv_bn2_override
    return tfqmr_loop(prim, v2, v3, v5, tau0, inv_bn2, tolerance,
                      max_iterations, dt, graphs=graphs, key=key)


def solve_core_panel(multiply: Callable[[Pair], Pair], b_panel: Pair,
                     v3_panel: Pair, tolerance: float, max_iterations: int,
                     inv_bn2_override=None, *, rhs_trivial: bool = False,
                     graphs=None, key: tuple = ()) -> SolveResult:
    """The panel engines' entry (JAX: core.solve_core_panel): vectors live
    as [NR, ncc, LN] panels (``ops/panel.py``); ``multiply`` returns masked
    panels and ``b_panel`` holds B (the unit blocks when ``rhs_trivial``).
    ``graphs`` and ``key`` are ``tfqmr_loop``'s."""
    from .ops.panel import make_panel_primitives

    prim = make_panel_primitives(multiply)
    v5 = (b_panel[0], b_panel[1])
    _, ncc, ln = b_panel[0].shape
    with trace("prepare"):
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
                      max_iterations, b_panel[0].dtype, graphs=graphs,
                      key=key)


def solve_core_fused(prim: TfqmrPrimitives, b_fused: torch.Tensor,
                     v3_fused: torch.Tensor, ncols: int, ln: int,
                     tolerance: float, max_iterations: int,
                     inv_bn2_override=None, *, rhs_trivial: bool = False,
                     graphs=None, key: tuple = ()) -> SolveResult:
    """The packed pairs engine's entry (JAX: the step of its solver's
    ``_solve_pairs``): vectors are fused permuted panels
    (``ops/pairpanel.fused_primitives``); ``b_fused`` holds B, or the unit
    blocks when ``rhs_trivial``.  ``graphs`` and ``key`` are
    ``tfqmr_loop``'s."""
    with trace("prepare"):
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
                      max_iterations, b_fused.dtype, graphs=graphs, key=key)


def flops_per_iteration(n_pairs: int, nnzb_x: int, lm: int, ln: int) -> float:
    """Flops of one iteration (2 SpMM + 2 dotp + 2 nrm2 + 10 axpy/xpay),
    by the reference's accounting (tfqmrgpu_core.hxx:133-138)."""
    return (2 * flops_spmm(n_pairs, lm, ln)
            + 2 * linalg.flops_dotp(nnzb_x, lm, ln)
            + 2 * linalg.flops_nrm2(nnzb_x, lm, ln)
            + 10 * linalg.flops_axpy(nnzb_x, lm, ln))


def flops_per_probe(n_pairs: int, nnzb_x: int, lm: int, ln: int) -> float:
    return flops_spmm(n_pairs, lm, ln) + linalg.flops_nrm2(nnzb_x, lm, ln)

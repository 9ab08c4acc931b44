"""The plain tfQMR of the reference library (tfqmrgpu_core.hxx:114-335),
on complex tensors, for the judge and for the control.

One right-hand side is one lane of a block column of X: the scalars are
[ncols, LN], the vectors X-shaped [nnzbX, LM, LN].  The recurrences, the
breakdown and stagnation rules, the shadow vector (uniform float32 numbers
from a generator seeded 1234, as the library's fixed cuRAND seed) and the
adaptive convergence control (a tau bound every iteration, the true
residual probed where the bound crosses a target) follow the library; the
scalar updates run in float64 and are stored in the vectors' precision.
Written from the library's description, with nothing of the program.

``solve`` returns the solution, the status (0 converged, 3 breakdown, 2 the
iteration cap), the iterations needed and the probes.
"""

from __future__ import annotations

import dataclasses

import torch

EPSILON = 2.5e-308
SHADOW_SEED = 1234
CONVERGED, MAX_ITERATIONS, BREAKDOWN = 0, 2, 3


@dataclasses.dataclass
class Outcome:
    x: torch.Tensor
    status: int
    iterations: int
    probes: int


def shadow_vector(nnzb_x: int, lm: int, ln: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(SHADOW_SEED)
    v = torch.rand((2, nnzb_x, lm, ln), generator=gen, dtype=torch.float32)
    return torch.complex(v[0].double(), v[1].double()).to(device)


def solve(op, b: torch.Tensor, tolerance: float, max_iterations: int,
          v3: torch.Tensor = None) -> Outcome:
    """tfQMR for op(x) = b, b X-shaped in ``op.dtype``."""
    dt = op.dtype
    nnzb, lm, ln = b.shape
    if v3 is None:
        v3 = shadow_vector(nnzb, lm, ln, b.device)
    v3 = v3.to(dt)

    def dot(x, y):                        # per RHS, unconjugated
        return op.column_sum((x * y).sum(dim=1))

    def norm2(x):                         # per RHS, squared
        return op.column_sum((x.real ** 2 + x.imag ** 2).sum(dim=1))

    def per_block(s):                     # [ncols, LN] -> [nnzbX, 1, LN]
        return s.to(dt)[op.col][:, None, :]

    tol2 = float(tolerance) ** 2
    zeros = torch.zeros_like(b)
    v1, v4, v6, v7, v8 = (zeros.clone() for _ in range(5))
    v5 = b.clone()
    tau = norm2(v5)
    inv_bn2 = torch.where(tau > 0, 1.0 / torch.where(tau > 0, tau, 1.0), 0.0)
    shape = tau.shape
    rho = torch.ones(shape, dtype=torch.complex128, device=b.device)
    eta = torch.zeros_like(rho)
    var = torch.zeros(shape, dtype=torch.float64, device=b.device)
    status = torch.zeros(shape, dtype=torch.int32, device=b.device)
    target = tol2 * 1e4
    probes, it, done = 0, 0, False
    needed = max_iterations

    def half_step_tau(d55, alfa):
        nonlocal var, tau, status
        ok = (tau.abs() > EPSILON) & torch.isfinite(d55)
        ratio = d55 / torch.where(ok, tau, 1.0)
        cosi = torch.where(ok, 1.0 / (1.0 + ratio), 0.0)
        var = torch.where(ok, ratio, 0.0)
        tau = torch.where(ok, d55 * cosi, 0.0)
        r67 = torch.where(ok, ratio * cosi, 1.0)
        status = torch.where(ok, status, -3)
        eta_new = torch.where(status < 0, 0.0, -cosi * alfa)
        return eta_new.to(dt).to(torch.complex128), r67

    while it < max_iterations and not done:
        it += 1
        # first half-step: dec35
        z35 = dot(v3, v5)
        bad = ((z35.abs() ** 2 < EPSILON) | (rho.abs() ** 2 < EPSILON)
               | ~torch.isfinite(z35) | ~torch.isfinite(rho))
        beta = torch.where(bad, 0.0, z35 / torch.where(bad, 1.0, rho))
        rho = torch.where(bad, 0.0, z35)
        status = torch.where(bad, -1, status)
        beta, rho = beta.to(dt).to(torch.complex128), rho.to(dt).to(
            torch.complex128)
        v6 = v5 + per_block(beta) * v6
        v4 = v8 + per_block(beta) * v4
        v9 = op(v6)
        v4 = v9 + per_block(beta) * v4
        # dec34
        z34 = dot(v3, v4)
        bad = ((z34.abs() ** 2 < EPSILON) | (rho.abs() ** 2 < EPSILON)
               | ~torch.isfinite(z34) | ~torch.isfinite(rho)
               | ~torch.isfinite(var))
        alfa = torch.where(bad, 0.0, -rho / torch.where(bad, 1.0, z34))
        c67 = torch.where(bad, 0.0, z34 * var * eta
                          / torch.where(bad, 1.0, rho))
        status = torch.where(bad, -2, status)
        alfa, c67 = (s.to(dt).to(torch.complex128) for s in (alfa, c67))
        v7 = v6 + per_block(c67) * v7
        v5 = v5 + per_block(alfa) * v9
        eta, r67 = half_step_tau(norm2(v5), alfa)
        v1 = v1 + per_block(eta) * v7
        v6 = v6 + per_block(alfa) * v4
        v7 = v6 + per_block(r67) * v7
        # second half-step
        v8 = op(v6)
        v5 = v5 + per_block(alfa) * v8
        eta, _ = half_step_tau(norm2(v5), alfa)
        v1 = v1 + per_block(eta) * v7
        # convergence control
        bound = float((tau * inv_bn2).max()) * (2 * it + 1)
        if bool(((status == -1) | (status == -2)).all()):
            return Outcome(v1, BREAKDOWN, max_iterations, probes)
        if bound <= target or it >= max_iterations:
            res2 = norm2(op(v1) - b) * inv_bn2
            done = bool(((res2 <= tol2) | (status != 0)).all())
            status = torch.where(res2 <= 0, 1, status)
            residual2 = max(float(res2.max()), EPSILON)
            target = bound / residual2 * tol2
            probes += 1
            if done:
                needed = it
    return Outcome(v1, CONVERGED if done else MAX_ITERATIONS, needed, probes)

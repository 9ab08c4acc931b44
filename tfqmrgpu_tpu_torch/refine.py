"""The mixed-precision iterative-refinement loop.

The 'm' mode iterates in complex64 and reaches float64 residuals by
classic iterative refinement: each round measures the true residual
r = B - A @ x with one float64 product and solves the correction A dX == r
with the fast float32 solver.  This loop is the JAX package's
``tfqmrgpu_tpu/refine.py`` (its lines 35-122) on torch tensors: the same
arguments, the same per-round target, the same stall and budget rules and
the same returned dict.  ``solver.refine_mixed`` drives it; the caller
injects the float64 product and the correction solve.  The reference
declares this mode and disables it (tfqmrgpu.cu:42 "mixed precision is
still buggy").

The round's bookkeeping stays on the device in float64 (re, im) planes:
the residual, its per-column squared norms and the iterate.  The one host
read per round is the convergence ratio.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .core import inverse_norms
from .plan import resolve_device


def _planes(c: np.ndarray, device) -> tuple:
    """A complex host array -> float64 (re, im) tensors on ``device``."""
    c = np.asarray(c, np.complex128)
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                 for p in (c.real, c.imag))


def refinement_loop(*, apply64: Callable, bx64, colindx, bn2, x0,
                    tolerance: float, max_iterations: int, total_iters: int,
                    inner_base: int, solve_correction: Callable,
                    stall_seed: float, flops_per_round: float = 0.0,
                    flops_per_iteration: float = 0.0, echo: int = 0,
                    max_rounds: int = 12, label: str = "refine",
                    device=None) -> dict:
    """Run the refinement rounds on ``device`` (the CUDA card unless given).

    Args:
      apply64: the float64 operator, (x_re, x_im) -> (y_re, y_im) on
        X-shaped [nnzbX, LM, LN] float64 tensors.
      bx64: B scattered into X's shape, complex128 [nnzbX, LM, LN] (host).
      colindx: int[nnzbX], the compressed column of each X block.
      bn2: [nCols, LN] squared column norms of B (0 where B is empty).
      x0: the starting iterate (the c stage's solution), as ``bx64``.
      total_iters: iterations already spent (the c stage).
      inner_base: the correction budget's scale (the c stage's count); each
        correction solve gets min(inner_base, 150) + 50 iterations, capped
        by what is left of ``max_iterations``.
      solve_correction: ((r_re, r_im) float64 tensors [nnzbX, LM, LN],
        res2 float64 tensor [nCols, LN], stall, inner_max) -> ((dx_re,
        dx_im) tensors, iterations int).
      stall_seed: the c stage's residuum; each round's target is twice it,
        clipped to the float32 stall band [1e-5, 1e-2].
      flops_per_round / flops_per_iteration: accounting weights (0 = none).

    Returns dict(x complex128 [nnzbX, LM, LN] on the host, ratio,
    total_iters, flops, rounds, converged).
    """
    device = resolve_device(device)
    f64 = torch.float64
    bn2 = torch.as_tensor(np.asarray(bn2, np.float64)).to(device)
    inv = inverse_norms(bn2)
    # a round gains about the float32 solver's stall level; seed it from
    # what the c stage reached, away from the extremes
    stall = float(np.clip(2.0 * max(stall_seed, 0.0), 1e-5, 1e-2))
    ncols, ln = bn2.shape
    cidx = torch.as_tensor(colindx).to(device, torch.int64)
    bxr, bxi = _planes(bx64, device)
    x_re, x_im = _planes(x0, device)
    prev_ratio = np.inf
    ratio = np.inf
    converged = False
    rounds = 0
    flops = 0.0
    for rnd in range(max_rounds):
        yr, yi = apply64(x_re, x_im)
        rr, ri = bxr - yr, bxi - yi
        blk = (rr * rr + ri * ri).sum(dim=1)                # [nnzbX, LN]
        res2 = torch.zeros((ncols, ln), dtype=f64,
                           device=device).index_add_(0, cidx, blk)
        flops += flops_per_round
        ratio = float(torch.sqrt((res2 * inv).max()))      # the host read
        if echo > 1:
            print(f"# {label} round {rnd}: rel residual {ratio:.3e}")
        if ratio <= tolerance:
            converged = True
            break
        if ratio > 0.25 * prev_ratio or total_iters >= max_iterations:
            break                 # stalled; the caller may fall back to 'z'
        prev_ratio = ratio
        rounds += 1
        inner_max = min(max_iterations - total_iters,
                        min(inner_base, 150) + 50)
        (dxr, dxi), inner_iters = solve_correction((rr, ri), res2, stall,
                                                   inner_max)
        x_re = x_re + dxr.to(device, f64)
        x_im = x_im + dxi.to(device, f64)
        total_iters += int(inner_iters)
        flops += int(inner_iters) * flops_per_iteration
    x = x_re.cpu().numpy() + 1j * x_im.cpu().numpy()
    return dict(x=x, ratio=ratio, total_iters=total_iters, flops=flops,
                rounds=rounds, converged=converged)

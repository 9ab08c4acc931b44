"""Mixed-precision ('m') sharded solve: float32 sharded iterations plus
float64-residual iterative refinement.

Counterpart of ``tfqmrgpu_tpu/parallel/mixed.py``, and the sharded
analogue of ``solver.solve_mixed``: the c stage and the correction solves
run on a sharded float32 engine (the row tiles, K3, or the packed pairs,
K2, over the ranks), while each
round measures the true residual with one float64 product, the pair-plan
kernel K1 over the whole plan (``PairPlanMultiply``; its plain version on
the CPU).  The residual runs replicated on every rank, as in the JAX
package: every rank computes the same bits and takes the same decisions,
so all of them enter each correction solve together.  The reference
declares 'm' and disables it (tfqmrgpu.cu:42 "mixed precision is still
buggy").
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pairpanel import PairPlanMultiply
from ..refine import refinement_loop


def solve_sharded_mixed(a, x, b, plan, sp, *, tolerance: float = 1e-9,
                        max_iterations: int = 999,
                        c_tolerance: float = 1e-4, max_rounds: int = 12,
                        echo: int = 0):
    """Refine a sharded float32 solve to float64 residuals.

    Args:
      a, x, b: the BSR operands (complex128 data on ``a``/``b``).
      plan: the analyzed plan (lm/ln set) on this rank's device.
      sp: a sharded solver (``ShardedRowTileSolver`` or
          ``ShardedPairsSolver``) built over ``plan`` and a mesh; its
          ``solve`` must accept ``rhs_xshaped``.

    Returns (x_blocks complex128 [nnzbX, LM, LN], info dict).
    """
    lm, ln = int(plan.lm), int(plan.ln)
    dev = sp.mesh.device
    ar = np.asarray(a.data.real)
    ai = np.asarray(a.data.imag)

    # stage 1: float32 sharded solve of A X == B
    maxit_c = min(max_iterations, max(150, max_iterations // 4))
    xc, info_c = sp.solve(ar, ai, np.asarray(b.data.real),
                          np.asarray(b.data.imag),
                          tolerance=max(c_tolerance, tolerance),
                          max_iterations=maxit_c)

    # the float64 residual operator: K1 over the plan's pair table
    apply = PairPlanMultiply(
        plan, *(torch.from_numpy(np.ascontiguousarray(v, np.float64)).to(dev)
                for v in (ar, ai)), ln)

    colindx = plan.colindx.cpu().numpy().astype(np.int64)
    bx64 = np.zeros((plan.nnzb_x, lm, ln), np.complex128)
    np.add.at(bx64, plan.subset.cpu().numpy().astype(np.int64),
              np.asarray(b.data, np.complex128))
    bn2 = np.zeros((plan.ncols, ln))
    np.add.at(bn2, colindx, (np.abs(bx64) ** 2).sum(axis=1))

    def _correction(r, res2, stall, inner_max):
        rr, ri = (v.cpu().numpy().astype(np.float32) for v in r)
        dx, info_d = sp.solve(ar, ai, rr, ri,
                              tolerance=stall, max_iterations=inner_max,
                              rhs_xshaped=True)
        dx = torch.from_numpy(np.asarray(dx, np.complex128))
        return ((dx.real.contiguous(), dx.imag.contiguous()),
                int(info_d["iterations"]))

    res = refinement_loop(
        apply64=lambda xr, xi: apply((xr, xi)), bx64=bx64, colindx=colindx,
        bn2=bn2, x0=np.asarray(xc), tolerance=tolerance,
        max_iterations=max_iterations,
        total_iters=int(info_c["iterations"]),
        inner_base=int(info_c["iterations"]),
        solve_correction=_correction,
        stall_seed=float(info_c["residuum"]),
        echo=echo, max_rounds=max_rounds, label="sharded refine", device=dev)

    info = dict(info_c)
    info.update(iterations=res["total_iters"], residuum=res["ratio"],
                refine_rounds=res["rounds"], converged=res["converged"],
                c_iterations=int(info_c["iterations"]))
    return res["x"], info

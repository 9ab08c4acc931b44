"""The comparison that decides ``correct``.

For every solve of the sample the judge builds the operator A_k from the
pool's host array, solves it with the reference's tfQMR in complex128, and
reads three numbers of the program's answer:

* ``resid``: the largest relative residual |A_k X - B| / |B| of a right-hand
  side, by the reference's own product over X's pattern;
* ``xdev``: max |X - X_ref| / max |X_ref|, X_ref the reference's solution;
* ``iter_gap``: |iterations - the reference's iterations|.

Each is the largest over the sample; each has its limit in the
configuration's file (``limits``).  A run is correct where every solve of
its window returned status 0, the reference converged on every sampled
point, and every number lies at or below its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tfqmr
from .operator import Operator

NUMBERS = ("resid", "xdev", "iter_gap")


def read(problem, a: np.ndarray, x: np.ndarray, iterations: int,
         tolerance: float, max_iterations: int, device) -> dict:
    """The numbers of one answer: the program's X (complex [nnzbX, LM,
    LN] on the host) and its iteration count, for the operator ``a``."""
    op = Operator(problem, a, device)
    b = op.rhs(problem.b_data)
    ref = tfqmr.solve(op, b, tolerance, max_iterations)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device, torch.complex128)
    r = op(xt) - b
    norm2 = op.column_sum((r.real ** 2 + r.imag ** 2).sum(dim=1))
    bn2 = op.column_sum((b.real ** 2 + b.imag ** 2).sum(dim=1))
    live = bn2 > 0
    resid = float((norm2[live] / bn2[live]).max().sqrt())
    xdev = float((xt - ref.x).abs().max() / ref.x.abs().max())
    return {"resid": resid, "xdev": xdev,
            "iter_gap": abs(int(iterations) - ref.iterations),
            "ref_status": ref.status, "ref_iterations": ref.iterations}


def combine(readings: list) -> dict:
    """The sample's numbers: the largest of each, and the reference's
    failures."""
    out = {k: max((r[k] for r in readings), default=float("nan"))
           for k in NUMBERS}
    out["ref_failed"] = sum(r["ref_status"] != tfqmr.CONVERGED
                            for r in readings)
    return out


def verdict(numbers: dict, limits: dict, failed: int,
            sampled: int) -> tuple:
    """(correct, checks): checks maps each name to its number and limit, in
    the order printed."""
    checks = {"failed": {"value": failed, "limit": 0},
              "ref_failed": {"value": numbers.get("ref_failed", 0),
                             "limit": 0}}
    for k in NUMBERS:
        checks[k] = {"value": numbers.get(k, float("nan")),
                     "limit": limits.get(k)}
    ok = sampled > 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks

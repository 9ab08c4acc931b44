"""Carry analysis state across from the JAX package, in numpy.

With ``plan_from_numpy`` and the solver's ``v3`` argument (or
``Solver.set_shadow_vector``), this package and ``tfqmrgpu_tpu`` compute
the same solve from the same inputs:

    jplan = tfqmrgpu_tpu.plan.create_plan(a, x, b)
    plan = plan_from_numpy(**{k: getattr(jplan, k) for k in PLAN_FIELDS},
                           device="cuda")
    v3 = tfqmrgpu_tpu.core.make_shadow_vector(jplan.nnzb_x, lm, ln)
    solver = Solver(a, x, b, plan=plan, device="cuda",
                    v3=tuple(np.asarray(v) for v in v3))

Nothing here imports JAX: the fields arrive as numpy arrays and ints.
"""

from __future__ import annotations

import numpy as np

from .errors import Status, TfqmrgpuError, encode_status
from .plan import Plan, plan_on_device, resolve_device

PLAN_FIELDS = ("pairs", "starts", "colindx", "subset", "rowptr_a",
               "colind_a", "rowptr_x", "nrows", "ncols", "nnzb_a", "nnzb_x",
               "nnzb_b")


def plan_from_numpy(*, pairs, starts, colindx, subset, rowptr_a, colind_a,
                    rowptr_x, nrows: int, ncols: int, nnzb_a: int,
                    nnzb_x: int, nnzb_b: int, device=None) -> Plan:
    """A ``Plan`` on ``device`` (the CUDA card unless given) from another
    plan's numpy tables (any integer dtype, for example the JAX plan's
    uint32 and uint16 ones).  The tables are checked against each other
    and against the counts."""
    device = resolve_device(device)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    starts = np.asarray(starts, dtype=np.int64)
    colindx = np.asarray(colindx, dtype=np.int64)
    subset = np.asarray(subset, dtype=np.int64)
    rowptr_a = np.asarray(rowptr_a, dtype=np.int64)
    colind_a = np.asarray(colind_a, dtype=np.int64)
    rowptr_x = np.asarray(rowptr_x, dtype=np.int64)
    problems = []
    if starts.shape != (nnzb_x + 1,) or starts[0] != 0 \
            or np.any(np.diff(starts) < 0) or starts[-1] != pairs.shape[0]:
        problems.append("starts must rise from 0 to nPairs over nnzbX+1 slots")
    if pairs.size and (pairs[:, 0].min() < 0 or pairs[:, 0].max() >= nnzb_a
                       or pairs[:, 1].min() < 0 or pairs[:, 1].max() >= nnzb_x):
        problems.append("pairs index outside A or X")
    if colindx.shape != (nnzb_x,) or (nnzb_x and (
            colindx.min() < 0 or colindx.max() >= ncols)):
        problems.append("colindx must give each X block a column < ncols")
    if subset.shape != (nnzb_b,) or (nnzb_b and (
            subset.min() < 0 or subset.max() >= nnzb_x)):
        problems.append("subset must give each B block an X block")
    for name, rowptr, nnzb in (("rowptr_a", rowptr_a, nnzb_a),
                               ("rowptr_x", rowptr_x, nnzb_x)):
        if rowptr.shape != (nrows + 1,) or rowptr[0] != 0 \
                or np.any(np.diff(rowptr) < 0) or rowptr[-1] != nnzb:
            problems.append(f"{name} must rise from 0 to its nnzb over "
                            "nrows+1 slots")
    if colind_a.shape != (nnzb_a,) or (nnzb_a and (
            colind_a.min() < 0 or colind_a.max() >= nrows)):
        problems.append("colind_a must give each A block a column < nrows")
    if problems:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR),
                            "; ".join(problems))
    return plan_on_device(nrows=nrows, ncols=ncols, nnzb_a=nnzb_a,
                          nnzb_x=nnzb_x, nnzb_b=nnzb_b, starts=starts,
                          pairs=pairs, subset=subset, colindx=colindx,
                          rowptr_a=rowptr_a, colind_a=colind_a,
                          rowptr_x=rowptr_x, device=device)

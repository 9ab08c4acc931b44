"""Weak-scaling harness for the sharded block-list solver.

Counterpart of ``tfqmrgpu_tpu/parallel/scaling.py``.  It reports nnz/s and
iterations-to-convergence over 1, 2, 4, ... row shards, one rank each
(BASELINE.json asks for weak-scaling efficiency).  Run it with every rank:

    torchrun --nproc_per_node=N -m tfqmrgpu_tpu_torch.parallel.scaling [MB]
    torchrun --nproc_per_node=N -m tfqmrgpu_tpu_torch.parallel.scaling \
        overhead [MB_TOTAL]

on N cards of one machine (``TFQ_DEVICE=cpu`` runs the ranks on the CPU
over gloo).  A point of pr shards runs on ranks 0 .. pr-1; the others wait
and every rank ends with rank 0's numbers.  Weak scaling: the problem grows
with the row-shard count (block rows proportional to pr) so per-shard work
stays constant.  Each wall is a host clock read after a
``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class ScalePoint:
    pr: int
    pc: int
    mb: int
    nnzb_a: int
    n_pairs: int
    iterations: int
    status: int
    wall_s: float
    nnz_mac_per_s: float
    wall_lo: float = 0.0     # fastest warm repeat
    wall_hi: float = 0.0     # slowest warm repeat
    repeats: int = 0
    device: str = ""         # where the point ran


def _banded_problem(mb: int, lm: int, ln: int, ncols: int, halfband: int,
                    seed: int = 0):
    """Deterministic banded block problem that weak-scales with mb."""
    from ..bsr import Bsr

    rng = np.random.default_rng(seed)
    rows, cols = [0], []
    for i in range(mb):
        lo, hi = max(0, i - halfband), min(mb, i + halfband + 1)
        cols.extend(range(lo, hi))
        rows.append(len(cols))
    nnzb = len(cols)
    data = (rng.standard_normal((nnzb, lm, lm))
            + 1j * rng.standard_normal((nnzb, lm, lm)))
    rowptr = np.asarray(rows)
    for i in range(mb):
        d = rows[i] + list(cols[rows[i]:rows[i + 1]]).index(i)
        data[d] += 6.0 * (2 * halfband + 1) * lm * np.eye(lm)
    a = Bsr(mb, mb, rowptr, np.asarray(cols), data, name="A")

    x = Bsr(mb, ncols, np.arange(mb + 1) * ncols,
            np.tile(np.arange(ncols), mb), None, name="X")
    rowptr_b = np.concatenate([[0], np.cumsum(
        [1 if r < ncols else 0 for r in range(mb)])])
    b_data = (rng.standard_normal((ncols, lm, ln))
              + 1j * rng.standard_normal((ncols, lm, ln)))
    b = Bsr(mb, ncols, rowptr_b, np.arange(ncols), b_data, name="B")
    return a, x, b


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run_point(pr: int, pc: int, mb_per_shard: int = 16, lm: int = 8,
              ln: int = 8, ncols: int = 4, tolerance: float = 1e-8,
              max_iterations: int = 300, repeats: int = 3,
              seed: int = 0, fixed_iterations: int = 0,
              device=None) -> ScalePoint:
    """One weak-scaling measurement on a pr x pc grid of ranks; every rank
    of the process group calls it and gets rank 0's point.

    ``fixed_iterations``: when > 0, run exactly that many iterations
    (unreachable tolerance) so every grid shape does identical per-shard
    work -- weak-scaled problems otherwise converge in different iteration
    counts, and per-solve overhead amortized over a lucky long solve
    masquerades as efficiency."""
    from ..plan import create_plan
    from . import make_mesh, partition_plan
    from .sharded import sharded_solve

    mesh = make_mesh(pr, pc, device=device)
    mb = mb_per_shard * pr
    a, x, b = _banded_problem(mb, lm, ln, ncols * pc, halfband=2, seed=seed)
    plan = create_plan(a, x, b, device=mesh.device)
    plan.lm, plan.ln = lm, ln
    if fixed_iterations:
        tolerance, max_iterations = 1e-30, fixed_iterations
    point = None
    if mesh.member:
        part = partition_plan(plan, pr, pc)
        sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
                else lambda: None)
        times = []
        info = None
        for i in range(repeats + 1):    # an extra warm-up solve
            sync()
            t0 = time.perf_counter()
            _, _, info = sharded_solve(
                plan, part, mesh, a.data.real, a.data.imag,
                b.data.real, b.data.imag, tolerance=tolerance,
                max_iterations=max_iterations)
            sync()
            dt = time.perf_counter() - t0
            if i:                       # discard the first (set-up laden)
                times.append(dt)
        best = float(np.median(times))
        iters = max(int(info["iterations"]), 1) if not fixed_iterations \
            else int(max_iterations)
        macs = plan.n_pairs * lm * lm * ln * iters
        point = ScalePoint(pr=pr, pc=pc, mb=mb, nnzb_a=a.nnzb,
                           n_pairs=plan.n_pairs, iterations=iters,
                           status=int(info["return_status"]), wall_s=best,
                           nnz_mac_per_s=macs / best,
                           wall_lo=float(np.min(times)),
                           wall_hi=float(np.max(times)),
                           repeats=len(times),
                           device=_device_name(mesh.device))
    box = [point]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _ranks(max_devices: Optional[int]) -> int:
    return int(max_devices or dist.get_world_size())


def weak_scaling_report(max_devices: Optional[int] = None,
                        mb_per_shard: int = 16,
                        fixed_iterations: int = 25, **kw):
    """Measure 1, 2, 4, 8 row shards (up to ``max_devices``, by default
    every rank); report per-shard efficiency against 1.

    Runs a FIXED iteration count per point (see run_point) so the nnz/s
    comparison is apples-to-apples across grid shapes."""
    n = _ranks(max_devices)
    points = [run_point(pr, 1, mb_per_shard=mb_per_shard,
                        fixed_iterations=fixed_iterations, **kw)
              for pr in (1, 2, 4, 8) if pr <= n]
    base = points[0]
    report = []
    for p in points:
        per_shard = p.nnz_mac_per_s / p.pr
        report.append(dict(pr=p.pr, mb=p.mb, iterations=p.iterations,
                           wall_s=p.wall_s, nnz_mac_per_s=p.nnz_mac_per_s,
                           efficiency=per_shard / base.nnz_mac_per_s,
                           device=p.device))
    return report


def host_overhead_report(mb_total: int = 128, fixed_iterations: int = 25,
                         max_devices: Optional[int] = None,
                         repeats: int = 9, **kw):
    """Fixed GLOBAL problem across grid shapes (strong scaling).

    The total work is the same at every pr.  On cards, 1/relative_wall
    (the pr=1 point's wall over this one's) is the strong-scaling speedup.
    Where the ranks share one host's cores (on the CPU) the ideal wall is
    flat, and ``sharding_overhead_pct`` (relative_wall - 1, in percent)
    isolates the sharded data path's own cost: collectives, halo padding,
    per-shard dispatch.

    Noise discipline: ``repeats`` warm solves per point (default 9), wall_s
    is the median, spread_pct the min..max range relative to it; a row
    whose |overhead| is below the larger of the two points' spreads carries
    resolved=False."""
    n = _ranks(max_devices)
    rows = []
    base = None
    base_spread = 0.0
    for pr in (1, 2, 4, 8):
        if pr > n or mb_total % pr:
            continue
        p = run_point(pr, 1, mb_per_shard=mb_total // pr,
                      fixed_iterations=fixed_iterations,
                      repeats=repeats, **kw)
        spread = 100.0 * (p.wall_hi - p.wall_lo) / max(p.wall_s, 1e-30)
        if base is None:
            base = p.wall_s
            base_spread = spread
        over = 100.0 * (p.wall_s / base - 1.0)
        rows.append(dict(pr=pr, mb=p.mb, iterations=p.iterations,
                         repeats=p.repeats, wall_s=p.wall_s,
                         wall_min_s=p.wall_lo, wall_max_s=p.wall_hi,
                         spread_pct=spread,
                         relative_wall=p.wall_s / base,
                         sharding_overhead_pct=over,
                         resolved=bool(abs(over) > max(spread,
                                                       base_spread) / 2),
                         device=p.device))
    return rows


def main(argv=None):
    import json
    import sys

    from .multihost import initialize, shutdown

    argv = list(sys.argv[1:] if argv is None else argv)
    device = initialize(device=os.environ.get("TFQ_DEVICE") or None)
    if argv and argv[0] == "overhead":
        rep = host_overhead_report(
            mb_total=int(argv[1]) if len(argv) > 1 else 128, device=device)
    else:
        rep = weak_scaling_report(
            mb_per_shard=int(argv[0]) if argv else 16, device=device)
    if dist.get_rank() == 0:
        for row in rep:
            print(json.dumps(row))
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

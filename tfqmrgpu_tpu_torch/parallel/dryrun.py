"""Every sharded engine on tiny shapes, over all ranks of a process group.

The port's counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: on a grid of ``n`` ranks it solves a tiny problem
to convergence with the block-list (K1), panel, packed-pairs (K2, the
halo-overlap split; and a wide band that forces the ``all_gather``) and
row-tile (K3) engines, and holds each against the single-device 'xla'
solve of the same problem with the JAX package's gates: X within 1e-3 of
the largest entry, iterations within 2.

    torchrun --nproc_per_node=N -m tfqmrgpu_tpu_torch.parallel.dryrun
    python -m tfqmrgpu_tpu_torch.parallel.dryrun           (a world of one)

On the CPU give ``--device cpu`` (gloo); on cards every rank takes its own
(NCCL).
"""

from __future__ import annotations

import numpy as np

TOLERANCE, MAX_ITERATIONS = 1e-4, 60
MAXDIFF, ITERATION_SLACK = 1e-3, 2


def _bsr(mb, ncol, rows, data, name):
    """A Bsr of ``mb`` block rows whose row i holds the columns rows[i]."""
    from ..bsr import Bsr

    rowptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return Bsr(mb, ncol, rowptr, np.array([c for r in rows for c in r],
                                          dtype=np.int64), data, name)


def _xb(rng, mb, ncols, lm, ln):
    """X full over ``ncols`` block columns; B the blocks (j, j)."""
    x = _bsr(mb, ncols, [list(range(ncols))] * mb, None, "X")
    b = _bsr(mb, ncols, [[r] if r < ncols else [] for r in range(mb)],
             (rng.standard_normal((ncols, lm, ln))
              + 1j * rng.standard_normal((ncols, lm, ln))), "B")
    return x, b


def _problem(mb, ncols, lm, ln, cols_of, shift, seed):
    """A with the block columns ``cols_of(i)`` in row i and ``shift``*I
    added to its diagonal blocks; complex64."""
    rng = np.random.default_rng(seed)
    rows = [sorted(cols_of(i)) for i in range(mb)]
    nnzb = sum(len(r) for r in rows)
    data = (rng.standard_normal((nnzb, lm, lm))
            + 1j * rng.standard_normal((nnzb, lm, lm)))
    k = 0
    for i, r in enumerate(rows):
        data[k + r.index(i)] += shift * np.eye(lm)
        k += len(r)
    a = _bsr(mb, mb, rows, data.astype(np.complex64), "A")
    x, b = _xb(rng, mb, ncols, lm, ln)
    return a, x, b.with_data(b.data.astype(np.complex64))


def tiny_problem(mb, ncols, lm, ln):
    """Rows {i, i+1, i+5} (mod mb), as the JAX package's ``_tiny_problem``."""
    return _problem(mb, ncols, lm, ln,
                    lambda i: {i, (i + 1) % mb, (i + 5) % mb}, 30.0, 0)


def banded_problem(mb, ncols, lm, ln, halfband=1):
    """A clamped band (no wrap) of ``halfband`` blocks each side: interior
    tiles are shard-local, so the packed engine's overlap split engages."""
    return _problem(mb, ncols, lm, ln,
                    lambda i: range(max(0, i - halfband),
                                    min(mb, i + halfband + 1)),
                    12.0 * (2 * halfband + 1 if halfband > 1 else 1) * lm,
                    7 + halfband)


def dryrun_multichip(n_devices: int = 0, device=None) -> dict:
    """Solve with every sharded engine on ``n_devices`` ranks (by default
    the whole world) and check each against the single-device solve.
    Returns {engine: dict(maxdiff, iterations, reference iterations,
    status, ...)}; raises on a failed gate.  Every rank calls it."""
    import torch.distributed as dist

    from ..plan import create_plan
    from ..solver import Solver
    from .multihost import initialize
    from .partition import partition_plan
    from .sharded import make_mesh, sharded_solve
    from .sharded_pairs import ShardedPairsSolver
    from .sharded_panel import ShardedPanelSolver
    from .sharded_rowtile import ShardedRowTileSolver

    dev = initialize(device=device)
    n = int(n_devices) or dist.get_world_size()
    # two column shards where n allows, so that both axes run
    pc = 2 if n % 2 == 0 and n > 2 else 1
    pr = n // pc
    lm = ln = 4
    out = {}

    def reference(a, x, b):
        s = Solver(a, x, b, precision="c", engine="xla", device=dev)
        info = s.solve(tolerance=TOLERANCE, max_iterations=MAX_ITERATIONS)
        return s.get_matrix("X"), info.iterations_needed

    def check(tag, ref, got, info, **extra):
        x_ref, it_ref = ref
        d = float(np.max(np.abs(np.asarray(got) - x_ref))
                  / max(float(np.max(np.abs(x_ref))), 1e-30))
        its = int(info["iterations"])
        if not (d < MAXDIFF and abs(its - it_ref) <= ITERATION_SLACK):
            raise AssertionError(f"{tag}: maxdiff {d:.3e}, {its} iterations "
                                 f"(single device {it_ref})")
        out[tag] = dict(maxdiff=d, iterations=its, reference=it_ref,
                        status=int(info["return_status"]), **extra)

    def planes(m):
        return m.data.real, m.data.imag

    a, x, b = tiny_problem(max(2 * pr, 8), max(2 * pc, 4), lm, ln)
    plan = create_plan(a, x, b, device=dev)
    plan.lm, plan.ln = lm, ln
    ref = reference(a, x, b)
    mesh = make_mesh(pr, pc, device=dev)
    xr, xi, info = sharded_solve(plan, partition_plan(plan, pr, pc), mesh,
                                 *planes(a), *planes(b), tolerance=TOLERANCE,
                                 max_iterations=MAX_ITERATIONS)
    check("block-list", ref, xr + 1j * xi, info, grid=(pr, pc))
    got, info = ShardedPanelSolver(plan, mesh, precision="c").solve(
        *planes(a), *planes(b), tolerance=TOLERANCE,
        max_iterations=MAX_ITERATIONS)
    check("panel", ref, got, info, grid=(pr, pc))

    mesh1 = make_mesh(n, 1, device=dev)
    mb = max(12 * n, 48)
    for tag, halfband in (("pairs", 1), ("pairs all_gather", mb // n + 2)):
        a, x, b = banded_problem(mb, 2, lm, ln, halfband)
        plan = create_plan(a, x, b, device=dev)
        plan.lm, plan.ln = lm, ln
        sp = ShardedPairsSolver(plan, mesh1)
        lay = sp.layout
        if tag == "pairs all_gather" and n > 1 and lay.halo:
            raise AssertionError("the wide band must force the all_gather")
        got, info = sp.solve(*planes(a), *planes(b), tolerance=TOLERANCE,
                             max_iterations=MAX_ITERATIONS)
        ref = reference(a, x, b)
        check(tag, ref, got, info, overlap=lay.overlap, n_loc=lay.n_loc,
              halo=lay.halo, h_lo=lay.h_lo, h_hi=lay.h_hi)
        if halfband == 1:
            got, info = ShardedRowTileSolver(plan, mesh1, r_tile=2).solve(
                *planes(a), *planes(b), tolerance=TOLERANCE,
                max_iterations=MAX_ITERATIONS)
            check("rowtile", ref, got, info)
    if dist.get_rank() == 0:
        for tag, r in out.items():
            print(f"dryrun_multichip({n}): {tag} ok, " + ", ".join(
                f"{k}={v:.2e}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()), flush=True)
    return out


def main(argv=None) -> int:
    import argparse

    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=0,
                    help="ranks of the grid (default: the whole world)")
    ap.add_argument("--device", default=None,
                    help="where each rank runs (default: its card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

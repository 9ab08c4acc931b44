"""Multi-rank layer over ``torch.distributed``: the counterpart of
``tfqmrgpu_tpu/parallel/`` (absent in the reference, which is single-GPU:
tfqmrgpu_handle.hxx:4-6).

Block rows of A, X and B are partitioned over the "rows" axis of a
(rows, cols) grid of ranks, one process and one device per rank; each rank
multiplies its shard against an X working set completed by halo exchange
(one ``all_gather``), and the per-RHS reductions finish with an
``all_reduce`` over the ranks.  Scalar recurrences are replicated.  Every
rank calls the same entry point with the same host inputs and returns the
full result.  NCCL carries the collectives between cards (``torchrun
--nproc_per_node=N``), gloo between CPU processes.

Engines: ``sharded`` (block lists, the pair-plan kernel K1 per shard),
``sharded_rowtile`` (row tiles, the kernel K3 per shard), ``sharded_pairs``
(the packed pair plan, the kernel K2 per shard, with the halo-overlap tile
split and the neighbour halo), ``sharded_panel`` (dense slabs,
``torch.matmul``); ``mixed`` refines to float64 residuals.
``comm_model`` prices the packed engine's collectives at the H100's
NVLink and memory rates; ``dryrun`` runs every engine on tiny shapes
against the single-device solve.
"""

from ..errors import Status, TfqmrgpuValueError, encode_status
from .partition import RowPartition, partition_plan
from .sharded import (Mesh, ShardedAction, make_mesh, sharded_solve,
                      sharded_solve_core)
from .sharded_pairs import ShardedPairsLayout, ShardedPairsSolver
from .sharded_panel import ShardedPanelSolver
from .sharded_rowtile import ShardedRowTileSolver

__all__ = ["RowPartition", "partition_plan", "Mesh", "ShardedAction",
           "sharded_solve", "sharded_solve_core", "make_mesh",
           "ShardedPairsLayout", "ShardedPairsSolver", "ShardedPanelSolver",
           "ShardedRowTileSolver", "solve_sharded"]


def solve_sharded(a, x, b, *, mesh=None, n_devices: int = 0,
                  engine: str = "auto", precision: str = "c",
                  tolerance: float = 1e-5, max_iterations: int = 300,
                  r_tile: int = 0, device=None):
    """One-call sharded solve: returns (X blocks complex, info dict), the
    same on every rank.

    The multi-rank analogue of ``tfqmrgpu_tpu_torch.solve``: builds the
    plan, shards A/X/B over a 1-D "rows" grid (``mesh``, or ``n_devices``
    ranks, by default every rank of the process group, on ``device``: this
    rank's card unless given), and solves with a sharded engine:

    * 'rowtile' -- union-ELL row slabs through K3, X panel gathered per
      multiply;
    * 'pairs'   -- the packed pair plan through K2 with the halo-overlap
      tile split (``ShardedPairsSolver`` in tiles of one block row; as in
      the JAX package, ``r_tile`` sets the row tiles only);
    * 'auto'    -- 'rowtile' when LM >= 8 and the X panel takes at most
      ``solver.PALLAS_X_BYTE_LIMIT`` (90 MiB), else 'pairs' (the JAX
      package's rule).

    precision 'c' iterates in float32; precision 'm' additionally refines
    to float64 residuals (``parallel.mixed``).  Stopping is globally
    synchronized.
    """
    import numpy as np

    if precision not in ("c", "m"):
        raise TfqmrgpuValueError(encode_status(Status.PRECISION_MISSMATCH),
                                 "sharded engines iterate in float32: use "
                                 "precision 'c', or 'm' for f64-residual "
                                 "refinement; plain 'z' runs on one device")
    plan, sp, eng = _build_sharded(a, x, b, mesh=mesh, n_devices=n_devices,
                                   engine=engine, r_tile=r_tile,
                                   device=device)
    if precision == "m":
        from .mixed import solve_sharded_mixed

        xc, info = solve_sharded_mixed(
            a, x, b, plan, sp, tolerance=tolerance,
            max_iterations=max_iterations)
    else:
        xc, info = sp.solve(np.asarray(a.data.real),
                            np.asarray(a.data.imag),
                            np.asarray(b.data.real),
                            np.asarray(b.data.imag),
                            tolerance=tolerance,
                            max_iterations=max_iterations)
    info["engine"] = eng
    return xc, info


def _build_sharded(a, x, b, *, mesh=None, n_devices: int = 0,
                   engine: str = "auto", r_tile: int = 0, device=None):
    """Shared plumbing of solve_sharded: plan + engine pick + solver."""
    import torch.distributed as dist

    if engine not in ("auto", "rowtile", "pairs"):
        raise TfqmrgpuValueError(encode_status(Status.NO_IMPLEMENTATION),
                                 f"unknown sharded engine {engine!r}")

    from ..plan import create_plan
    from ..solver import PALLAS_X_BYTE_LIMIT
    from .multihost import initialize

    if mesh is None:
        initialize(device=device)
        mesh = make_mesh(int(n_devices) or dist.get_world_size(), 1,
                         device=device)
    plan = create_plan(a, x, b, device=mesh.device)
    lm = a.slow_block_dim or b.slow_block_dim
    ln = b.fast_block_dim or lm
    plan.lm, plan.ln = int(lm), int(ln)
    eng = engine
    if eng == "auto":
        x_panel_bytes = 2 * plan.nrows * plan.lm * plan.ncols * plan.ln * 4
        eng = "rowtile" if (plan.lm >= 8 and x_panel_bytes
                            <= PALLAS_X_BYTE_LIMIT) else "pairs"
    if eng == "rowtile":
        sp = ShardedRowTileSolver(plan, mesh, r_tile=r_tile)
    else:
        sp = ShardedPairsSolver(plan, mesh)
    return plan, sp, eng

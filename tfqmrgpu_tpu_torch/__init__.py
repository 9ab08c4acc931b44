"""tfqmrgpu_tpu_torch: the block-sparse tfQMR solver in PyTorch and CUDA.

A port of ``tfqmrgpu_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  It
solves ``A @ X == B`` for block-sparse complex operators in BSR format,
vectorized over many right-hand sides, with the reference tfQMRgpu
library's numerics.  The module names follow the JAX package's.

* ``plan.py``      -- the analysis step: pair list, subset, column tables.
* ``core.py``      -- the tfQMR iteration.
* ``solver.py``    -- ``Solver`` (with ``solve_checkpointed``) and the
                      one-call ``bsrsv`` / ``bsrsv_z`` / ``bsrsv_c`` /
                      ``bsrsv_m``; engines 'dense', 'pallas' (row tiles),
                      'pairs', 'xla' and 'auto'; mixed precision 'm'
                      through ``solve_mixed``.
* ``refine.py``    -- the iterative-refinement loop of 'm'.
* ``ops/``         -- vector ops, decisions, the plain block-sparse product,
                      the panel layout and the wrappers of the Hopper
                      kernels (``csrc/pairpanel_spmm.cu``,
                      ``csrc/pairpanel_tiles.cu`` and
                      ``csrc/rowtile_spmm.cu`` over the shared
                      ``csrc/panel_stage.cuh``, built by ``_build.py``) with
                      their host tables (``ops/paneltiles.py``).
* ``dma_probe.py`` -- the device-memory stream probe
                      (``csrc/dma_probe.cu``).
* ``convert.py``   -- hands a JAX plan's tables to this package.
* ``generator.py`` -- the finite-difference example problem and its XML
                      export (``python -m tfqmrgpu_tpu_torch.generator``).
* ``io/``          -- XML, legacy and pair-plan problem files.
* ``bench.py``     -- the reference benchmark's ``tfQMR`` mode on a problem
                      file (``python -m tfqmrgpu_tpu_torch.bench``).
* ``api.py``       -- the reference's plan-handle C API in Python (handles,
                      plans, bufferSize, setMatrix, solve, getInfo,
                      getMatrix, the one-call ``bsrsv_z/_c/_m``).
* ``capi_bridge.py``, ``native.py``, ``capi/`` -- the C library
                      ``libtfqmrgpu_tpu_torch.so`` (embedded CPython over
                      ``api``), its build, Fortran wrappers and module, and
                      the C++ analysis step; ``examples/`` drive it from C,
                      Fortran, Julia and Python.
* ``parallel/``    -- the sharded solvers over ``torch.distributed`` (one
                      rank per process and device: NCCL on the cards, gloo
                      on the CPU): ``solve_sharded``, block lists on K1,
                      row tiles on K3, dense slabs, 'm', the scaling
                      harness.
* ``profiling.py`` -- trace ranges (``TFQ_TRACE``), the HBM rate, the
                      per-iteration roofline and timed solves.
* ``autotune.py``  -- ``autotune_solver``: engines and their knobs raced on
                      the caller's pattern, cached per pattern and card.

Every entry point runs on the CUDA card unless it is given
``device="cpu"``; without a card it raises.
"""

from .bsr import BlockSparseMatrix, Bsr
from .errors import Status, TfqmrgpuError, get_error_string
from .ops.pairpanel import KERNEL_BLOCK_SIZES as ALLOWED_BLOCK_SIZES
from .plan import Plan, create_plan
from .solver import (Solver, bsrsv, bsrsv_c, bsrsv_m, bsrsv_z, solve,
                     solve_mixed)
from . import ops, parallel, profiling
from .autotune import autotune_solver

__version__ = "0.1.0"

__all__ = ["Bsr", "BlockSparseMatrix", "Plan", "create_plan", "Solver", "solve", "solve_mixed",
           "bsrsv", "bsrsv_z", "bsrsv_c", "bsrsv_m", "TfqmrgpuError",
           "Status", "get_error_string", "ALLOWED_BLOCK_SIZES",
           "allowed_block_sizes", "block_size_missing", "ops", "parallel",
           "profiling", "autotune_solver"]


def allowed_block_sizes() -> list:
    """The (LM, LN) pairs the reference library compiles, which are the
    sizes the hand-written kernels take (tfqmrgpu.cu:75-90)."""
    return list(ALLOWED_BLOCK_SIZES)


def block_size_missing(ldA: int, ldB: int) -> int:
    """0 if (ldA, ldB) is an allowed block-size pair, else the
    BLOCKSIZE_MISSING status (tfqmrgpu.cu:93-106)."""
    return 0 if (ldA, ldB) in ALLOWED_BLOCK_SIZES else int(
        Status.BLOCKSIZE_MISSING)

"""tfqmrgpu_tpu_torch: the block-sparse tfQMR solver in PyTorch and CUDA.

A port of ``tfqmrgpu_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  It
solves ``A @ X == B`` for block-sparse complex operators in BSR format,
vectorized over many right-hand sides, with the reference tfQMRgpu
library's numerics.  The module names follow the JAX package's.

* ``plan.py``      -- the analysis step: pair list, subset, column tables.
* ``core.py``      -- the tfQMR iteration.
* ``solver.py``    -- ``Solver`` and the one-call ``bsrsv_z`` / ``bsrsv_c``;
                      engines 'dense', 'pallas' (row tiles), 'pairs', 'xla'
                      and 'auto'.
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
* ``generator.py`` -- the finite-difference example problem.

Every entry point runs on the CUDA card unless it is given
``device="cpu"``; without a card it raises.
"""

from .bsr import Bsr
from .errors import Status, TfqmrgpuError
from .ops.pairpanel import KERNEL_BLOCK_SIZES as ALLOWED_BLOCK_SIZES
from .plan import Plan, create_plan
from .solver import Solver, bsrsv_c, bsrsv_z, solve

__all__ = ["Bsr", "Plan", "create_plan", "Solver", "solve", "bsrsv_z",
           "bsrsv_c", "TfqmrgpuError", "Status", "ALLOWED_BLOCK_SIZES"]

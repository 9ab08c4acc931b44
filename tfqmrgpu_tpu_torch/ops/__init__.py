"""Operator library.

* ``layout``      -- host layout conversion (RIRIRIRI interleave, split
                     re/im planes, block transpose and conjugation).
* ``linalg``      -- per-column vector ops: axpy/xpay, segmented dotp/nrm2,
                     RHS scatter-add.
* ``decisions``   -- the three tfQMR scalar decision updates.
* ``blocksparse`` -- block-sparse Y = A @ X over the pair list, in plain
                     PyTorch (the 'xla' engine and the kernel's reference).
* ``pairpanel``   -- the 'pairs' engine: the wrapper of the pair-table
                     kernel K1 ('z'), and for 'c' the host packing (column
                     groups, the resident union-ELL plan), the fused-panel
                     primitives and the wrapper of the packed kernel K2.
* ``panel``       -- the panel layout and primitives of the 'dense' and
                     row-tile engines, and the dense multiply.
* ``pallas_spmm`` -- the row-tile packing and the wrapper of the
                     hand-written Hopper row-tile kernel (the 'pallas'
                     engine); ``recover_grid``.
* ``ozaki``       -- float64-quality products from exact bf16 slice
                     products (the opt-ins TFQ_XLA_OZ and TFQ_Z_OZAKI).

``pairpanel`` also holds the 'c' precision modes (``PRECISIONS``, the bf16
splits) that K2 and K3 run.
"""

from . import blocksparse, decisions, layout, linalg, pairpanel, pallas_spmm, panel

__all__ = ["layout", "linalg", "decisions", "blocksparse", "pairpanel",
           "panel", "pallas_spmm"]

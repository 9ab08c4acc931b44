"""Sharded ROW-TILE solver: the row-tile engine over a 1-D grid of ranks.

Counterpart of ``tfqmrgpu_tpu/parallel/sharded_rowtile.py``.  Shards the
row-tile engine (ops/pallas_spmm.py) over the "rows" axis: each rank owns
a slab of A's block rows packed into union-ELL row tiles (A blocks stream
once for ALL RHS columns), completes its X operand with one
``all_gather`` of the panel over "rows" (``sharded.Halo``), runs the
row-tile kernel K3 (``RowTileMultiply``) on the gathered panel with the
slab's tiles, masks to X's pattern, and finishes the per-RHS reductions
with one ``all_reduce`` a call.  Scalar recurrences replicate; the
convergence control takes maxima over every rank, so stopping agrees with
the single-device engine.

Compared to ``ShardedPanelSolver`` (dense slabs) this keeps A block-sparse:
the per-multiply A traffic is nnzbA-proportional, not (mb*LM)^2.  float32
only, as in the JAX package, in K3's exact FP32 or a bf16 split mode
(``mm_prec``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import core
from ..errors import Status, TfqmrgpuError, encode_status
from ..ops import pallas_spmm as rt
from ..ops.pairpanel import check_precision
from ..ops.panel import PanelLayout
from .multihost import gather_global, put_global
from .sharded import Halo, Mesh, halo_index
from .sharded_panel import _ceil_to, panel_loop


class ShardedRowTileSolver:
    """Host side: packs each shard's row slab into row-tile panels.

    ``r_tile`` 0 takes max(1, 128 // LM), the JAX package's default;
    ``mm_prec`` is K3's matmul precision (``RowTileMultiply``'s
    ``precision``: 'highest', or a bf16 split mode), the JAX package's
    argument and default."""

    def __init__(self, plan, mesh: Mesh, precision: str = "c",
                 r_tile: int = 0, mm_prec: str = "highest"):
        self.mm_prec = check_precision(mm_prec)
        if precision != "c":
            raise TfqmrgpuError(encode_status(Status.PRECISION_MISSMATCH),
                                "the row-tile engine is float32-only")
        if mesh.pc != 1:
            raise ValueError("the row-tile engine shards block rows only: "
                             "it takes a (pr, 1) mesh")
        mesh.require_member()
        self.plan = plan
        self.mesh = mesh
        self.pr = mesh.pr
        self.lm, self.ln = plan.lm, plan.ln
        self.lay = PanelLayout.from_plan(plan)
        lm = self.lm

        r_tile = r_tile or max(1, 128 // lm)
        self.mb_pad = _ceil_to(_ceil_to(self.lay.mb, r_tile), self.pr * r_tile)
        self.mb_local = self.mb_pad // self.pr
        self.nrl = self.mb_local * lm
        self.nr = self.mb_pad * lm
        self.ncc = self.lay.ncc
        self.c = self.ncc * self.ln

        # per-shard row-tile packing of the PADDED A pattern (pad rows are
        # empty); ku padded to the max over shards, as in the JAX package
        rowptr = np.zeros(self.mb_pad + 1, np.int64)
        rowptr[: plan.nrows + 1] = plan.rowptr_a
        rowptr[plan.nrows + 1:] = plan.rowptr_a[-1]
        packs = []
        for s in range(self.pr):
            lo, hi = s * self.mb_local, (s + 1) * self.mb_local
            rp = (rowptr[lo: hi + 1] - rowptr[lo]).astype(np.int64)
            ci = plan.colind_a[rowptr[lo]: rowptr[hi]].astype(np.int64)
            packs.append(rt.pack_row_tiles(rp, ci, self.mb_local, lm, r_tile))
        self.r_tile = r_tile
        self.ku = max(p.ku for p in packs)
        # this slab's pack, its union block rows named by their index in
        # the gathered halo (block row g of shard g // mb_local)
        p = packs[mesh.row]
        xcols = np.zeros((p.ntiles, self.ku), np.int64)
        xcols[:, : p.ku] = p.xcols
        xcols = halo_index(xcols // self.mb_local, xcols % self.mb_local,
                           self.mb_local)
        self.pack = p._replace(ku=self.ku, xcols=xcols.astype(np.int32))
        # X-pattern mask, padded and row-sharded: [pr, mb_local, ncc]
        mask = np.zeros((self.mb_pad, self.ncc), bool)
        mask[: self.lay.mb] = self.lay.mask
        self.mask_sh = mask.reshape(self.pr, self.mb_local, self.ncc)

        v3 = core.make_shadow_vector(plan.nnzb_x, lm, self.ln, device="cpu")
        self.v3 = tuple(put_global(self._shard_panel(self.lay.pack_x(
            v.numpy())), mesh, ("rows",)) for v in v3)
        self._k3 = None
        self._halo = Halo(mesh, self.nrl, self.nrl, (self.ncc, self.ln),
                          torch.float32)

    # ------------------------------------------------------------- helpers

    def _shard_panel(self, p):
        """[NR0, ncc, LN] -> [pr, nrl, ncc, LN] (rows padded)."""
        p = np.asarray(p)
        out = np.zeros((self.nr, self.ncc, self.ln), p.dtype)
        out[: p.shape[0]] = p
        return np.ascontiguousarray(
            out.reshape(self.pr, self.nrl, self.ncc, self.ln))

    def set_matrix_a(self, a_re: np.ndarray, a_im: np.ndarray):
        """Build this slab's fused panels on the device and its K3."""
        rowptr = self.plan.rowptr_a
        lo = self.mesh.row * self.mb_local
        blk_lo = int(rowptr[min(lo, self.plan.nrows)])
        blk_hi = int(rowptr[min(lo + self.mb_local, self.plan.nrows)])
        panels = [rt.build_a_panels_device(self.pack, torch.from_numpy(
            np.ascontiguousarray(v[blk_lo:blk_hi], np.float32)).to(
                self.mesh.device)) for v in (a_re, a_im)]
        self._k3 = rt.RowTileMultiply(
            self.pack, *panels, self.mask_sh[self.mesh.row], self.ln,
            x_rows=(2 * self.pr - 1) * self.mb_local, precision=self.mm_prec)

    def multiply(self, x) -> tuple:
        """The halo ``all_gather`` of the X panel, then K3 (masked)."""
        return self._k3(self._halo(x))

    # --------------------------------------------------------------- solve

    def solve(self, a_re, a_im, b_re, b_im, tolerance=1e-5,
              max_iterations=300, rhs_xshaped=False):
        """``rhs_xshaped=True`` takes the RHS as X-shaped blocks
        [nnzbX, LM, LN] (mixed-refinement correction solves)."""
        if self._k3 is None:
            self.set_matrix_a(np.asarray(a_re), np.asarray(a_im))
        pack = self.lay.pack_x if rhs_xshaped else self.lay.pack_b
        b = tuple(put_global(self._shard_panel(pack(np.asarray(
            v, np.float32))), self.mesh, ("rows",)) for v in (b_re, b_im))
        res = panel_loop(self.mesh, self.multiply, b, self.v3,
                         float(tolerance), int(max_iterations))
        xs = gather_global(torch.stack(res.x), self.mesh, ("rows",))
        xp = (xs[:, 0].reshape(self.nr, self.ncc, self.ln)
              + 1j * xs[:, 1].reshape(self.nr, self.ncc, self.ln))
        x_blocks = self.lay.unpack_x(xp[: self.lay.nr])
        info = dict(return_status=int(res.return_status),
                    iterations=int(res.iterations),
                    residuum=float(res.residuum), n_probes=int(res.n_probes),
                    rhs_status=res.rhs_status.cpu().numpy())
        return x_blocks, info

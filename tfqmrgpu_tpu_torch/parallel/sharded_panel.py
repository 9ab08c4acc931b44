"""Sharded PANEL solver: the dense-slab engine over a (rows, cols) grid.

Counterpart of ``tfqmrgpu_tpu/parallel/sharded_panel.py``.  The block-list
solver (sharded.py) mirrors the reference-shaped data structures; this
module shards the dense-panel engine instead (ops/panel.py): vectors are
dense row panels ``[NR, ncc, LN]`` and the block-SpMM is one full-depth
masked matmul.

Sharding over a (rows, cols) grid of ranks:

* row axis: block rows of A and the panels are split into equal chunks
  (padded).  A is stored as its local row slab ``[NR_local, NR]``; the
  SpMM completes the X operand with one ``all_gather`` over "rows" (the
  halo exchange: for a dense slab the halo is everything) and contracts
  locally with four ``torch.matmul`` calls, native float64 for 'z' and
  full float32 for 'c' (TF32 refused, as ``ops/panel.dense_multiply``
  does).  The JAX package leaves this product to XLA outside any kernel,
  so it is no kernel here either.
* col axis: compressed block columns of X/B are split; columns never
  couple in tfQMR, so A is replicated over "cols" and only the
  convergence maxima cross that axis.
* dotp/nrm2: local panel column sums + one ``all_reduce`` over "rows";
  scalar recurrences replicate per column shard; convergence control uses
  maxima over every rank, so stopping agrees with a single device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import core
from ..ops.panel import (PanelLayout, _refuse_tf32, apply_mask,
                         make_panel_primitives)
from .multihost import gather_global, put_global
from .sharded import Halo, Mesh, sharded_primitives


def _ceil_to(n: int, k: int) -> int:
    return -(-n // k) * k


def panel_loop(mesh: Mesh, multiply, b, v3, tolerance: float,
               max_iterations: int, col_valid: torch.Tensor = None,
               rhs_trivial: bool = False) -> core.SolveResult:
    """The loop over this rank's panel shards ``b`` and ``v3`` [NRl, nccl,
    LN] with the masked ``multiply``; ``col_valid`` bool [nccl] marks the
    column chunk's real columns (all of them when None)."""
    prim = sharded_primitives(mesh, make_panel_primitives(multiply, b))
    _, nccl, ln = b[0].shape
    colv = (torch.ones(nccl, dtype=torch.bool, device=b[0].device)
            if col_valid is None else col_valid)[:, None].expand(nccl, ln)
    v5 = (b[0], b[1])
    if rhs_trivial:
        tau0 = colv.to(torch.float64)
        inv_bn2 = tau0
    else:
        tau0 = prim.nrm2(v5)
        inv_bn2 = torch.where(colv, core.inverse_norms(tau0), 0.0)
    return core.tfqmr_loop(prim, b, v3, v5, tau0, inv_bn2, tolerance,
                           max_iterations, b[0].dtype)


def sharded_panel_solve_core(mesh: Mesh, a_re, a_im, b, v3, mask,
                             col_valid, tolerance: float,
                             max_iterations: int, *, lm: int, ln: int,
                             rhs_trivial: bool = False) -> core.SolveResult:
    """This rank's loop: ``a_re``, ``a_im`` its row slab [NRl, NR] of dense
    A, ``b`` and ``v3`` its panel shards [NRl, nccl, LN], ``mask`` [mbl,
    nccl] the X pattern of its shard, ``col_valid`` bool [nccl]."""
    dt = a_re.dtype
    nrl, nr = (int(s) for s in a_re.shape)
    mbl, nccl = (int(s) for s in mask.shape)
    c_l = nccl * ln
    mask4 = mask[:, None, :, None].to(dt)
    halo = Halo(mesh, nrl, nrl, (nccl, ln), dt)
    f32 = dt == torch.float32
    if f32:
        _refuse_tf32()

    def multiply(x):
        if f32:
            _refuse_tf32()
        halo(x)                              # X of every row shard
        xr = halo.recv[:, 0].reshape(nr, c_l)
        xi = halo.recv[:, 1].reshape(nr, c_l)
        yr = a_re @ xr - a_im @ xi
        yi = a_re @ xi + a_im @ xr
        return apply_mask((yr.reshape(nrl, nccl, ln),
                           yi.reshape(nrl, nccl, ln)), mask4, mbl, lm, nccl,
                          ln)

    return panel_loop(mesh, multiply, b, v3, tolerance, max_iterations,
                      col_valid, rhs_trivial)


class ShardedPanelSolver:
    """Host side: pads and partitions a plan's panel layout over the mesh.
    ``v3``: the shadow vector as host (re, im) [nnzbX, LM, LN], by default
    ``core.make_shadow_vector``'s."""

    def __init__(self, plan, mesh: Mesh, precision: str = "c", v3=None):
        mesh.require_member()
        self.plan = plan
        self.mesh = mesh
        self.pr = mesh.shape["rows"]
        self.pc = mesh.shape["cols"]
        self.lm, self.ln = plan.lm, plan.ln
        self.lay = PanelLayout.from_plan(plan)
        self.mb_pad = _ceil_to(self.lay.mb, self.pr)
        self.ncc_pad = _ceil_to(self.lay.ncc, self.pc)
        self.npdt = np.float64 if precision == "z" else np.float32

        mask = np.zeros((self.mb_pad, self.ncc_pad), np.float64)
        mask[: self.lay.mb, : self.lay.ncc] = self.lay.mask
        self.mask = self._shard_cols_rows(
            mask.reshape(self.mb_pad, 1, self.ncc_pad, 1)
        )[:, :, :, 0, :, 0]
        cv = np.zeros((self.pc, self.ncc_pad // self.pc), bool)
        cv.reshape(-1)[: self.lay.ncc] = True
        self.col_valid = cv

        if v3 is None:
            v3 = core.make_shadow_vector(plan.nnzb_x, self.lm, self.ln,
                                         device="cpu")
        v3 = [v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
              for v in v3]
        self.v3 = (self._shard_panel(self.lay.pack_x(v3[0])),
                   self._shard_panel(self.lay.pack_x(v3[1])))

    def _pad_panel(self, p):
        nr, ncc = self.mb_pad * self.lm, self.ncc_pad
        out = np.zeros((nr, ncc, self.ln), p.dtype)
        out[: p.shape[0], : p.shape[1]] = p
        return out

    def _shard_panel(self, p):
        """[NR, ncc, LN] -> [pr, pc, NRl, nccl, LN]."""
        p = self._pad_panel(np.asarray(p))
        nrl = p.shape[0] // self.pr
        nccl = p.shape[1] // self.pc
        return np.ascontiguousarray(
            p.reshape(self.pr, nrl, self.pc, nccl, self.ln)
            .transpose(0, 2, 1, 3, 4))

    def _unshard_panel(self, s):
        s = np.asarray(s)
        pr, pc, nrl, nccl, ln = s.shape
        p = s.transpose(0, 2, 1, 3, 4).reshape(pr * nrl, pc * nccl, ln)
        return p[: self.lay.nr, : self.lay.ncc]

    def _shard_cols_rows(self, arr):
        """[mb_pad, 1, ncc_pad, 1] -> [pr, pc, mbl, 1, nccl, 1]."""
        mbl = self.mb_pad // self.pr
        nccl = self.ncc_pad // self.pc
        return np.ascontiguousarray(
            arr.reshape(self.pr, mbl, 1, self.pc, nccl, 1)
            .transpose(0, 3, 1, 2, 4, 5))

    def _shard_a(self, dr, di):
        """dense [NR, NR] planes -> [pr, NRl, NR] row slabs (padded)."""
        nr = self.mb_pad * self.lm
        out_r = np.zeros((nr, nr), dr.dtype)
        out_i = np.zeros((nr, nr), di.dtype)
        n0 = dr.shape[0]
        out_r[:n0, :n0] = dr
        out_i[:n0, :n0] = di
        nrl = nr // self.pr
        return (out_r.reshape(self.pr, nrl, nr),
                out_i.reshape(self.pr, nrl, nr))

    def solve(self, a_blocks_re, a_blocks_im, b_blocks_re, b_blocks_im,
              tolerance=1e-6, max_iterations=999, rhs_trivial=False):
        mesh = self.mesh
        dr, di = self.lay.densify_a(
            self.plan, np.asarray(a_blocks_re).astype(self.npdt),
            np.asarray(a_blocks_im).astype(self.npdt))
        a_re, a_im = (put_global(s, mesh, ("rows",))
                      for s in self._shard_a(dr, di))
        b = tuple(put_global(self._shard_panel(self.lay.pack_b(
            np.asarray(v).astype(self.npdt))), mesh) for v in
            (b_blocks_re, b_blocks_im))
        v3 = tuple(put_global(v, mesh) for v in self.v3)
        res = sharded_panel_solve_core(
            mesh, a_re, a_im, b, v3,
            put_global(self.mask.astype(self.npdt), mesh),
            put_global(self.col_valid, mesh, ("cols",)),
            tolerance, max_iterations, lm=self.lm, ln=self.ln,
            rhs_trivial=rhs_trivial)
        xs = gather_global(torch.stack(res.x), mesh)  # [pr, pc, 2, ...]
        xp = (self._unshard_panel(xs[:, :, 0])
              + 1j * self._unshard_panel(xs[:, :, 1]))
        x_blocks = self.lay.unpack_x(xp)
        rhs_status = gather_global(res.rhs_status, mesh, ("cols",))
        info = dict(return_status=int(res.return_status),
                    iterations=int(res.iterations),
                    residuum=float(res.residuum), n_probes=int(res.n_probes),
                    rhs_status=rhs_status.reshape(-1, self.ln))
        return x_blocks, info

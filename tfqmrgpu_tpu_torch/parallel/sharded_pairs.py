"""Sharded packed-pairs engine: the packed pair plan and K2 over a 1-D grid
of ranks.

Counterpart of ``tfqmrgpu_tpu/parallel/sharded_pairs.py``, over
``torch.distributed`` (one process and one device per rank, SPMD).  The
packed 'c' engine of the single-device solver (``solver.pack_pairs``:
column groups, the resident union-ELL plan, fused permuted vectors) is
sharded over the "rows" axis:

* the plan's tiles are split into ``pr`` equal contiguous chunks; a rank
  holds its chunk's A panels and its chunk's vector rows (``tiles_local *
  r_tile * LM`` rows of every fused vector);
* **halo overlap**: tiles whose X blocks all lie in the rank's own rows are
  *local*; the others form a prefix and a suffix of every chunk (the
  relabelled tiles are sorted, so the local run is contiguous), *remote*.
  A multiply first issues the halo collective, then runs K2 on the local
  tiles over the rank's own rows while the collective is in flight, waits,
  and runs K2 on the remote tiles; every launch writes its rows of one Y;
* **neighbour halo**: where every remote tile reads only blocks of the two
  adjacent shards, within ``h_lo`` blocks below and ``h_hi`` above, the
  collective is an edge exchange (``Mesh.neighbour_exchange``) and the
  remote tiles read the rank's rows extended by the two edge slabs: the
  bytes a rank moves stay constant as the grid grows.  Otherwise it is one
  asynchronous ``all_gather`` of the whole panel;
* ``dotp``/``nrm2`` take float32 sums per group over the rank's slots, one
  ``all_reduce`` a call, then the remap to columns and the cast to float64
  (``pairpanel.fused_primitives``); the convergence scalars take maxima
  over every rank, so stopping agrees with the single-device engine.

At one rank every tile is local and X equals ``Solver(engine='pairs')``'s
to the bit, in every matmul precision (``precision``: K2's exact FP32
'highest', the default, or a bf16 split mode on the BF16 tensor cores, as
``PairPanelMultiply`` takes it).  Not ported, as for the single-device
engine: the TPU's windowed layouts, ``t_step``, and the VMEM and copy-code
limits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import core
from ..graphloop import LoopGraphs, refill
from ..ops import pairpanel as pp
from .multihost import gather_global, put_global
from .sharded import Mesh


class ShardTiles(NamedTuple):
    """One shard's tile-id lists (-1: a pad tile) and where their X blocks
    are read: the local run over the shard's own rows (from block
    ``local_base``), the remote prefix and suffix over the gathered or
    extended panel (from block ``remote_base``, ``remote_span`` blocks)."""

    local: np.ndarray
    prefix: np.ndarray
    suffix: np.ndarray
    local_base: int
    remote_base: int
    remote_span: int


class ShardedPairsLayout:
    """The host side of the sharded packed-pairs engine for ``pr`` shards,
    from the plan's pattern alone (numpy; no process group).

    ``group_size`` 0 picks the column groups by ``solver.choose_group_size``,
    1 groups nothing, G > 1 forces G (the JAX package's
    ``TFQ_PAIRS_COLGROUP``); ``halo`` False forces the ``all_gather`` (its
    ``TFQ_SHARDED_HALO=0``); ``overlap`` False makes every tile remote.
    The fields are the JAX solver's, for its resident plans."""

    def __init__(self, plan, pr: int, r_tile: int = 1, overlap: bool = True,
                 halo: bool = True, group_size: int = 0):
        from ..solver import pack_pairs

        self.pr = int(pr)
        self.lm, self.ln0 = int(plan.lm), int(plan.ln)
        self.ncc, self.nnzb_x = int(plan.ncols), int(plan.nnzb_x)
        self.gp, self.pp_plan = pack_pairs(plan, self.lm, self.ln0,
                                           group_size, r_tile)
        p0, lm = self.pp_plan, self.lm
        self.group_size = self.gp.group_size if self.gp is not None else 1
        self.ln = p0.ln                       # lanes of a plane: G*LN
        self.n_oh = self.gp.ngroups if self.gp is not None else self.ncc
        self.r_tile = p0.r_tile

        # tiles -> pr equal contiguous chunks (a resident plan has no window
        # grid, so any whole-tile chunking works)
        tl = max(-(-p0.ntiles // self.pr), 1)
        self.tiles_local = tl
        self.ntiles_pad = tl * self.pr
        self.vrows_local = tl * self.r_tile * lm
        self.vec_rows_pad = self.ntiles_pad * self.r_tile * lm
        bl = self.blocks_local = self.vrows_local // lm

        # local/remote split: a tile is local when its X blocks lie in the
        # shard's own rows; the others must form a prefix and a suffix of
        # every chunk, uniform p and q (the max over shards); pad tiles
        # read nothing and count as local
        idx = np.arange(p0.ntiles)
        lo_blk = p0.xloc[idx, 0].astype(np.int64)
        hi_blk = p0.xloc[idx, np.maximum(p0.kcount - 1, 0)].astype(np.int64)
        p_max = q_max = 0
        for s in range(self.pr):
            ids = np.arange(s * tl, (s + 1) * tl)
            real = ids < p0.ntiles
            ok = np.ones(tl, bool)
            rr = ids[real]
            ok[real] = (lo_blk[rr] >= s * bl) & (hi_blk[rr] < (s + 1) * bl)
            if not ok.any():
                p_max = tl
                break
            first_ok = int(np.argmax(ok))
            last_ok = tl - 1 - int(np.argmax(ok[::-1]))
            if not ok[first_ok: last_ok + 1].all():
                p_max = tl            # a split local run: no overlap
                break
            p_max = max(p_max, first_ok)
            q_max = max(q_max, tl - 1 - last_ok)
        self.overlap = bool(overlap) and p_max + q_max < tl
        self.p, self.q = (p_max, q_max) if self.overlap else (tl, 0)
        self.n_loc = tl - self.p - self.q
        # the local call reads the shard's whole X slice (the JAX package's
        # resident local window, which its VMEM limits could refuse)
        self.loc_resident = self.n_loc > 0

        # neighbour halo: when every remote tile reads only rows of the
        # adjacent shards, the remote call reads the shard's rows extended
        # by h_lo blocks below and h_hi above (uniform: the max over shards)
        self.h_lo = self.h_hi = 0
        self.halo = False
        if halo and self.p + self.q and self.p + self.q < tl:
            h_lo = h_hi = 0
            for s in range(self.pr):
                ids = np.concatenate([np.arange(s * tl, s * tl + self.p),
                                      np.arange((s + 1) * tl - self.q,
                                                (s + 1) * tl)])
                ids = ids[ids < p0.ntiles]
                if ids.size == 0:
                    continue
                h_lo = max(h_lo, int(np.max(s * bl - lo_blk[ids], initial=0)))
                h_hi = max(h_hi, int(np.max(hi_blk[ids] + 1 - (s + 1) * bl,
                                            initial=0)))
            if h_lo <= bl and h_hi <= bl:
                self.h_lo, self.h_hi = h_lo, h_hi
                self.halo = True
        # every shard's tile lists, their rebased tables checked here
        self.shards = [self._shard_tiles(s) for s in range(self.pr)]
        # the plan's pairs whose Y block each shard holds (the products its
        # multiply needs)
        per_blk = np.diff(plan.starts.cpu().numpy()).astype(np.int64)
        cell = (self.gp.cell_of_blk if self.gp is not None
                else np.arange(self.nnzb_x))
        shard = p0.inv_perm[cell] // self.r_tile // tl
        self.pairs_local = np.bincount(shard, weights=per_blk,
                                       minlength=self.pr).astype(np.int64)

    def _shard_tiles(self, s: int) -> ShardTiles:
        """Shard ``s``'s tile lists (the JAX package's ``_build_tables``,
        resident tile-pipe branches)."""
        tl, p, q, bl = self.tiles_local, self.p, self.q, self.blocks_local
        chunk = np.arange(s * tl, (s + 1) * tl, dtype=np.int64)
        chunk[chunk >= self.pp_plan.ntiles] = -1
        if self.halo:
            base, span = s * bl - self.h_lo, bl + self.h_lo + self.h_hi
        else:
            base, span = 0, self.pr * bl
        t = ShardTiles(local=chunk[p:tl - q], prefix=chunk[:p],
                       suffix=chunk[tl - q:tl], local_base=s * bl,
                       remote_base=base, remote_span=span)
        pp.tile_tables(self.pp_plan, t.local, t.local_base, bl)
        pp.tile_tables(self.pp_plan, np.concatenate([t.prefix, t.suffix]),
                       base, span)
        return t

    def slot_group(self, s: int) -> np.ndarray:
        """The group of each of shard ``s``'s slots (its column when
        ungrouped), -1 for a pad slot."""
        n = self.vrows_local // self.lm
        slots = np.arange(s * n, (s + 1) * n)
        real = slots < self.pp_plan.n_slots
        out = np.full(n, -1, np.int64)
        out[real] = self.pp_plan.col_of_new[slots[real]]
        return out

    def lane_mask(self, s: int):
        """Shard ``s``'s rows of the grouped lane mask (zeros on pad slots),
        or None when ungrouped."""
        if self.gp is None:
            return None
        m = pp.grouped_lane_mask(self.pp_plan, self.gp)
        n = self.vrows_local // self.lm
        out = np.zeros((n, m.shape[1]), np.float32)
        rows = m[s * n:(s + 1) * n]
        out[:rows.shape[0]] = rows
        return out

    def pack_vec(self, re_blocks: np.ndarray, im_blocks: np.ndarray,
                 scatter: np.ndarray = None) -> np.ndarray:
        """X-shaped blocks [nnzbX, LM, LN] (or B-shaped ones scattered to X
        blocks ``scatter``) -> row-sharded fused vectors [pr, vrows_local,
        2*LN'] (grouped, relabelled, padded)."""
        if scatter is not None:
            xr = np.zeros((self.nnzb_x, self.lm, self.ln0), re_blocks.dtype)
            xi = np.zeros_like(xr)
            np.add.at(xr, scatter, re_blocks)
            np.add.at(xi, scatter, im_blocks)
            re_blocks, im_blocks = xr, xi
        if self.gp is not None:
            re_blocks = pp.grouped_blocks(self.gp, re_blocks)
            im_blocks = pp.grouped_blocks(self.gp, im_blocks)
        flat = pp.permute_x(self.pp_plan, re_blocks, im_blocks)
        out = np.zeros((self.vec_rows_pad, 2 * self.ln), flat.dtype)
        out[:flat.shape[0]] = flat
        return out.reshape(self.pr, self.vrows_local, 2 * self.ln)

    def unpack_vec(self, shards: np.ndarray) -> tuple:
        """The inverse of ``pack_vec``: [pr, vrows_local, 2*LN'] -> (re, im)
        [nnzbX, LM, LN]."""
        p0 = self.pp_plan
        flat = np.asarray(shards).reshape(self.vec_rows_pad, 2 * self.ln)
        re, im = pp.unpermute_y(p0, flat[:p0.n_slots * self.lm])
        if self.gp is not None:
            re = pp.ungroup_blocks(self.gp, re)
            im = pp.ungroup_blocks(self.gp, im)
        return re, im


def pairs_multiply(mesh: Mesh, lay: ShardedPairsLayout, k2: tuple,
                   xr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A rank's rows of ``A @ x`` (unmasked) with its K2s ``k2`` (local run,
    prefix, suffix; None where empty) and its remote panel ``xr``: the halo
    collective first, K2 on the local tiles over the rank's own rows while
    it is in flight, then K2 on the remote tiles over the gathered or
    extended panel.

    In the loop graph the collective is a branch of the WHILE body on
    NCCL's stream, forked from the capture stream and joined back by
    ``wait()``, beside the local K2 on the capture stream; the body's
    blocks come from one private pool that serves allocations in capture
    order.  That order is sound across the fork: NCCL's branch reads only
    ``x`` and the slices of it that it sends, which the caller holds past
    the join, and writes only ``xr``, which lies outside the pool; no block
    is allocated on NCCL's stream, and the blocks the local branch frees
    (its own temporaries) are ones NCCL's branch never touches.  After the
    join the body is one chain again."""
    loc, pre, suf = k2
    m = lay.r_tile * lay.lm
    y = torch.empty_like(x)
    works = []
    if xr is not None:
        if lay.halo:
            hl, rows = lay.h_lo * lay.lm, lay.vrows_local
            works = mesh.neighbour_exchange(
                x[rows - hl:], xr[:hl], x[:lay.h_hi * lay.lm],
                xr[hl + rows:])
            xr[hl:hl + rows].copy_(x)
        else:
            works = [mesh.all_gather_async(xr, x)]
    if loc is not None:
        loc(x, y, lay.p * m)
    for w in works:
        w.wait()
    if pre is not None:
        pre(xr, y, 0)
    if suf is not None:
        suf(xr, y, (lay.tiles_local - lay.q) * m)
    return y


class ShardedPairsSolver:
    """This rank's part of a sharded packed-pairs solve over a (pr, 1)
    ``mesh``: the layout (``ShardedPairsLayout``) and, once A is set, K2
    (``PairPanelMultiply``) over the shard's local run, its remote prefix
    and its remote suffix.  ``r_tile``, ``overlap``, ``halo`` and
    ``group_size`` go to the layout; ``precision`` is K2's matmul precision
    (the JAX package's argument and default; a split mode needs LM >= 16
    and raises ValueError below)."""

    def __init__(self, plan, mesh: Mesh, r_tile: int = 1,
                 overlap: bool = True, halo: bool = True,
                 group_size: int = 0, precision: str = "highest"):
        self.precision = pp.check_precision(precision)
        if mesh.pc != 1:
            raise ValueError("the packed pairs engine shards tiles only: it "
                             "takes a (pr, 1) mesh")
        mesh.require_member()
        self.plan, self.mesh = plan, mesh
        self.layout = lay = ShardedPairsLayout(
            plan, mesh.pr, r_tile=r_tile, overlap=overlap, halo=halo,
            group_size=group_size)
        if precision != "highest" and lay.lm < 16:
            raise ValueError(f"precision {precision!r} needs LM >= 16, got "
                             f"{lay.lm}")
        self.tiles = lay.shards[mesh.row]
        self._k2 = None
        self._prim = None
        self.loop_graphs = LoopGraphs()
        rows, c2 = lay.vrows_local, 2 * lay.ln
        self._remote_x = None      # the gathered or the extended X panel
        if lay.p + lay.q:
            n = ((lay.h_lo + lay.blocks_local + lay.h_hi) * lay.lm if lay.halo
                 else lay.pr * rows)
            self._remote_x = torch.zeros((n, c2), dtype=torch.float32,
                                         device=mesh.device)

    def set_matrix_a(self, a_re: np.ndarray, a_im: np.ndarray):
        """Build K2 for the shard's tiles from the host planes of every A
        block (the same on every rank); where the loop graphs captured K2s
        of the same tables, the new panels go into them and the graphs
        stay."""
        lay, t, p0 = self.layout, self.tiles, self.layout.pp_plan
        a = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            self.mesh.device) for v in (a_re, a_im)]

        def k2(tiles, base, span):
            if tiles.size == 0:
                return None
            return pp.PairPanelMultiply(
                p0, pp.build_a_panels_device(p0, *a, tiles=tiles),
                tiles=tiles, src_base=base, span=span,
                precision=self.precision)

        new = (k2(t.local, t.local_base, lay.blocks_local),
               k2(t.prefix, t.remote_base, t.remote_span),
               k2(t.suffix, t.remote_base, t.remote_span))
        if not (self.loop_graphs and refill(self._k2, new)):
            self.loop_graphs.clear()
            self._k2, self._prim = new, None

    def multiply(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``A @ x`` (unmasked): ``pairs_multiply``
        with the shard's K2 and remote panel."""
        return pairs_multiply(self.mesh, self.layout, self._k2,
                              self._remote_x, x)

    def solve(self, a_re, a_im, b_re, b_im, tolerance: float = 1e-5,
              max_iterations: int = 300, rhs_xshaped: bool = False,
              v3=None):
        """Solve on every rank of the mesh from the host planes of A
        [nnzbA, LM, LM] and B [nnzbB, LM, LN] (the same on every rank;
        float32 is what runs).  ``rhs_xshaped=True`` takes the RHS as
        X-shaped blocks [nnzbX, LM, LN] (the mixed refinement's correction
        solves); ``v3`` the shadow vector as host (re, im) [nnzbX, LM, LN],
        by default ``core.make_shadow_vector``'s.  Returns (X blocks
        complex [nnzbX, LM, LN], info dict), the same on every rank."""
        lay, mesh, plan = self.layout, self.mesh, self.plan
        if self._k2 is None:
            self.set_matrix_a(np.asarray(a_re), np.asarray(a_im))
        scatter = (None if rhs_xshaped
                   else plan.subset.cpu().numpy().astype(np.int64))
        b = put_global(lay.pack_vec(np.asarray(b_re, np.float32),
                                    np.asarray(b_im, np.float32), scatter),
                       mesh, ("rows",))
        if v3 is None:
            v3 = core.make_shadow_vector(plan.nnzb_x, lay.lm, lay.ln0,
                                         device="cpu")
        v3 = put_global(lay.pack_vec(*(
            np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float32)
            for v in v3)), mesh, ("rows",))
        if self._prim is None:
            # the loop's multiply holds the K2s and the panel, not the
            # solver: the graphs the solver keeps hold the primitives, and
            # through a bound method they would keep the solver, and so
            # themselves, alive past its last use, and NCCL cannot destroy
            # a communicator while a graph holds its captured work
            mult = functools.partial(pairs_multiply, mesh, lay, self._k2,
                                     self._remote_x)
            self._prim = dataclasses.replace(pp.fused_primitives(
                mult, lay.pp_plan, lay.ncc, b, lay.gp,
                slot_group=lay.slot_group(mesh.row),
                lane_mask=lay.lane_mask(mesh.row), psum=mesh.psum),
                mesh=mesh)
        res = core.solve_core_fused(self._prim, b, v3, lay.ncc, lay.ln0,
                                    float(tolerance), int(max_iterations),
                                    graphs=self.loop_graphs, key=("pairs",))
        re, im = lay.unpack_vec(gather_global(res.x, mesh, ("rows",)))
        info = dict(return_status=int(res.return_status),
                    iterations=int(res.iterations),
                    residuum=float(res.residuum), n_probes=int(res.n_probes),
                    rhs_status=res.rhs_status.cpu().numpy())
        return re + 1j * im, info

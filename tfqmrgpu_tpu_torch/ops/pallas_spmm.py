"""The row-tile engine: host packing of A into row-tile union panels, and
the wrapper of the hand-written Hopper kernel ``csrc/rowtile_spmm.cu``
(K3; its staged product is ``csrc/panel_stage.cuh``, shared with K2, and
its unit tables and work list come from ``ops/paneltiles.py``).

The module keeps the name of its counterpart, ``tfqmrgpu_tpu/ops/pallas_spmm.py``,
whose TPU kernel K3 (``_make_call.kernel``, line 214) this package replaces;
the solver's engine name ``'pallas'`` keeps the JAX package's name too.

Block rows are grouped into tiles of ``r_tile`` rows.  For every tile the
union of its rows' A block columns (``ku`` of them, padded to the largest
tile) is taken and the tile's blocks are scattered into a dense panel
[r_tile*LM, ku*LM]; absent blocks are zero.  The multiply then gathers the
tile's union block rows of the X panel [nr, c] (c = ncc*LN, each A block
streams once for all right-hand-side columns) and multiplies them with the
panel, re and im rows fused:

    d_r = [ar; ai] @ xs_re,   d_i = [ar; ai] @ xs_im
    y_re = d_r[:rlm] - d_i[rlm:],   y_im = d_i[:rlm] + d_r[rlm:]

cut to ``nr`` rows and masked to X's pattern.  float32 operands only, as
in the JAX package, multiplied in exact FP32 ('highest') or in the JAX
package's bf16 split modes (``RowTileMultiply``'s ``precision``, the
solver's ``TFQ_PALLAS_MM_PREC``).  ``recover_grid`` factors a bare pair
list into a (row slot x column) grid, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import launch_counts
from ..errors import Status, TfqmrgpuError, encode_status
from . import paneltiles
from .pairpanel import (SPLIT_PRODUCTS, check_precision,
                        split_product)

# the modes the row-tile kernel splits; its 'bf16' runs 'highest', as the
# JAX kernel's does (its pallas_spmm.py:209-263)
SPLIT_ROWTILE = ("bf16x3", "bf16x4", "bf16x6")

Pair = tuple


class RowTilePack(NamedTuple):
    """Host-side packing of BSR A into row-tile union panels."""

    ntiles: int
    r_tile: int
    ku: int             # union columns per tile (padded to the max)
    lm: int
    xcols: np.ndarray   # int32[ntiles, ku]  union block-column ids (pad -> 0)
    # scatter map: a_panels[tile, rslot*LM:+LM, kslot*LM:+LM] = A[src]
    tile_of: np.ndarray     # int32[nnzbA]
    rslot_of: np.ndarray    # int32[nnzbA]
    kslot_of: np.ndarray    # int32[nnzbA]
    inflation: float        # packed panel volume / nnzbA block volume


def pack_row_tiles(rowptr_a: np.ndarray, colind_a: np.ndarray, mb: int,
                   lm: int, r_tile: int = 8) -> RowTilePack:
    """The union-ELL packing tables (pattern only, data-independent)."""
    rowptr = np.asarray(rowptr_a, dtype=np.int64)
    colind = np.asarray(colind_a, dtype=np.int64)
    nnzb = colind.shape[0]
    ntiles = math.ceil(mb / r_tile)

    tile_cols = []
    ku = 1
    for t in range(ntiles):
        r0, r1 = t * r_tile, min((t + 1) * r_tile, mb)
        cols = np.unique(colind[rowptr[r0]:rowptr[r1]])
        tile_cols.append(cols)
        ku = max(ku, cols.shape[0])

    xcols = np.zeros((ntiles, ku), dtype=np.int32)
    tile_of = np.zeros(nnzb, dtype=np.int32)
    rslot_of = np.zeros(nnzb, dtype=np.int32)
    kslot_of = np.zeros(nnzb, dtype=np.int32)
    row_of = np.repeat(np.arange(mb, dtype=np.int64), np.diff(rowptr))
    for t in range(ntiles):
        cols = tile_cols[t]
        xcols[t, : cols.shape[0]] = cols
        r0, r1 = t * r_tile, min((t + 1) * r_tile, mb)
        lo, hi = rowptr[r0], rowptr[r1]
        tile_of[lo:hi] = t
        rslot_of[lo:hi] = row_of[lo:hi] - r0
        kslot_of[lo:hi] = np.searchsorted(cols, colind[lo:hi])

    inflation = (ntiles * r_tile * ku) / max(nnzb, 1)
    return RowTilePack(ntiles=ntiles, r_tile=r_tile, ku=ku, lm=lm,
                       xcols=xcols, tile_of=tile_of, rslot_of=rslot_of,
                       kslot_of=kslot_of, inflation=float(inflation))


def choose_row_tile(plan, lm: int, r_tile: Optional[int] = None
                    ) -> RowTilePack:
    """The pack of the JAX solver's r_tile choice (its solver.py:164-175):
    among r_tile in {128/LM, 64/LM, 32/LM, 1} (floored, at least 1) the one
    with the least inflation over the row-utilization factor
    min(1, 2*r*LM/128), which the JAX package took from the TPU's 128-row
    matrix unit; an H100 rule is later work.  A given ``r_tile`` is taken
    as it is (the Solver's TFQ_PALLAS_RTILE, which ``autotune`` races)."""
    cands = ([r_tile] if r_tile else
             sorted({max(1, 128 // lm), max(1, 64 // lm), max(1, 32 // lm),
                     1}, reverse=True))
    best = None
    for r_tile in cands:
        p = pack_row_tiles(plan.rowptr_a, plan.colind_a, plan.nrows, lm,
                           r_tile)
        score = p.inflation / min(1.0, 2 * r_tile * lm / 128)
        if best is None or score < best[0]:
            best = (score, p)
    return best[1]


class PairGrid(NamedTuple):
    """A (row-slot x column) grid factorization of a bare pair list, for
    the row-tile engine (the JAX package's ``PairGrid``).

    Row slots are the pair list's connected row fragments
    (``pairpanel.recover_geometry``), ordered by Cuthill-McKee rank so that
    neighbouring slots share A operands.  Fragments of one true matrix row
    that never share an A block stay separate slots, so the grid's density
    is nnzb / (nfrag * ncol); a caller checks it before choosing the
    engine."""

    nslots: int
    ncols: int
    slot_of: np.ndarray      # int32[nnzb] row slot of each X/Y block
    col_of: np.ndarray       # int32[nnzb]
    rowptr: np.ndarray       # int64[nslots+1] slot-A CSR
    colind: np.ndarray       # int64[nnzbA] operand slots
    a_order: np.ndarray      # int64[nnzbA]: slot-A position -> original pa


def recover_grid(pair_a, pair_x, pair_y, nnzb: int) -> PairGrid:
    """Factor a bare pair list into a (slot x col) grid (see ``PairGrid``).
    A block ids that no pair uses (plan files carry them) appear nowhere."""
    from .pairpanel import _cuthill_mckee, recover_geometry

    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    frag, col = recover_geometry(pa, px, py, nnzb)
    nfrag = int(frag.max()) + 1
    ncol = int(col.max()) + 1
    # one slot per fragment, in Cuthill-McKee order: the rank is the slot
    slot_of_frag = _cuthill_mckee(nfrag, frag[py], frag[px])

    # the A blocks' endpoints in fragment space (each used id has one)
    o = np.argsort(pa, kind="stable")
    first = np.concatenate([[True], pa[o][1:] != pa[o][:-1]])
    used = pa[o][first]                   # the used ids, ascending
    fy = frag[py[o][first]]
    fx = frag[px[o][first]]

    slot_of = slot_of_frag[frag].astype(np.int32)
    ra = slot_of_frag[fy]
    ca = slot_of_frag[fx]
    csr_order = np.lexsort((ca, ra))
    rowptr = np.searchsorted(ra[csr_order], np.arange(nfrag + 1))
    return PairGrid(nslots=int(nfrag), ncols=int(ncol), slot_of=slot_of,
                    col_of=col.astype(np.int32),
                    rowptr=rowptr.astype(np.int64),
                    colind=ca[csr_order],
                    a_order=used[csr_order])


def build_a_panels(pack: RowTilePack, a_blocks: np.ndarray) -> np.ndarray:
    """Scatter [nnzbA, LM, LM] block data into [ntiles, R*LM, ku*LM] panels
    on the host (duplicate pattern entries add up)."""
    lm, r = pack.lm, pack.r_tile
    p = np.zeros((pack.ntiles, r, lm, pack.ku, lm), dtype=a_blocks.dtype)
    np.add.at(p, (pack.tile_of, pack.rslot_of, slice(None), pack.kslot_of),
              a_blocks)
    return np.ascontiguousarray(p.reshape(pack.ntiles, r * lm, pack.ku * lm))


def build_a_panels_device(pack: RowTilePack,
                          a_blocks: torch.Tensor) -> torch.Tensor:
    """The same panels built where ``a_blocks`` lies, with one
    ``index_add_`` (duplicate pattern entries add up)."""
    lm, r, ku = pack.lm, pack.r_tile, pack.ku
    base = torch.from_numpy(
        (pack.tile_of.astype(np.int64) * r + pack.rslot_of) * ku
        + pack.kslot_of).to(a_blocks.device)
    flat = a_blocks.new_zeros((pack.ntiles * r * ku, lm, lm))
    flat.index_add_(0, base, a_blocks)
    p = flat.reshape(pack.ntiles, r, ku, lm, lm).permute(0, 1, 3, 2, 4)
    return p.reshape(pack.ntiles, r * lm, ku * lm).contiguous()


class RowTileMultiply(metaclass=launch_counts.CountedLaunches):
    """Masked ``y = A @ x`` on [nr, ncc, LN] float32 panels over row-tile
    union panels.

    On a CUDA tensor it launches ``csrc/rowtile_spmm.cu``, which also
    applies the mask; on a CPU tensor it runs ``plain``.  On the card the
    fused panels are kept once, depth-major ([ntiles, ku*LM, 2*rlm], the
    layout the kernel stages from); ``a_fused`` is then a transposed view
    of them.  ``slots`` overrides the CTAs the work list is dealt to (by
    default what the card holds at once); the result does not depend on it.
    ``x_rows`` is the block rows of the X panel that ``xcols`` index, where
    it is not the mask's (a shard reads a gathered panel); y has the
    mask's rows.  ``launches`` reads the kernel's launch counter on the
    card (``launch_counts``); the plain version never adds to it.

    ``precision`` is one of ``pairpanel.PRECISIONS`` (an unknown string
    raises ValueError, where the JAX kernel silently runs 'highest').
    'highest' and 'bf16' run the exact FP32 kernel above, as the JAX
    kernel runs its 'bf16' at HIGHEST; 'bf16x3', 'bf16x4' and 'bf16x6' run
    the X split pass (``paneltiles.XSplit``) and then
    ``csrc/rowtile_spmm_bf16.cu`` on the BF16 tensor cores over A split once
    into staged bf16 slabs (``paneltiles.SplitOperands``), with
    ``split_launches`` reading its counter, and their plain version is
    ``pairpanel.split_product`` in the order of the kernel's products (K2's).
    """

    _counters = {"launches": "k3", "split_launches": "k3_split"}

    def __init__(self, pack: RowTilePack, a_re: torch.Tensor,
                 a_im: torch.Tensor, mask: np.ndarray, ln: int,
                 slots: int = None, x_rows: int = None,
                 precision: str = "highest"):
        self.precision = check_precision(precision)
        # the mode that runs: the JAX kernel splits only x3, x4 and x6
        self.mode = precision if precision in SPLIT_ROWTILE else "highest"
        self.split = self.mode != "highest"
        self.ntiles, self.ku, self.lm = pack.ntiles, pack.ku, pack.lm
        self.rlm = pack.r_tile * pack.lm
        self.mb, self.ncc = (int(s) for s in mask.shape)
        self.x_mb = self.mb if x_rows is None else int(x_rows)
        self.ln = int(ln)
        self.nr, self.c = self.mb * self.lm, self.ncc * self.ln
        dev = a_re.device
        if a_re.dtype != torch.float32 or a_im.dtype != torch.float32:
            raise TfqmrgpuError(encode_status(Status.PRECISION_MISSMATCH),
                                "the row-tile engine is float32-only, got "
                                f"{a_re.dtype}/{a_im.dtype}")
        shape = (self.ntiles, self.rlm, self.ku * self.lm)
        for name, t in (("a_re", a_re), ("a_im", a_im)):
            if tuple(t.shape) != shape or t.device != dev:
                raise ValueError(f"{name} must be a {shape} tensor on {dev}, "
                                 f"got {tuple(t.shape)} on {t.device}")
        if pack.xcols.size and int(pack.xcols.max()) >= self.x_mb:
            raise ValueError("xcols names a block row outside the X panel")
        if dev.type == "cuda" and self.lm % 4:
            raise TfqmrgpuError(encode_status(Status.BLOCKSIZE_MISSING),
                                f"the row-tile kernel takes LM in multiples "
                                f"of 4, got {self.lm}")
        # the real entries of a tile's block list: its union's size
        kcount = np.zeros(self.ntiles, np.int64)
        np.maximum.at(kcount, pack.tile_of, pack.kslot_of.astype(np.int64) + 1)
        self.kcount = kcount
        shape = paneltiles.mma_shape(self.c) if self.split else None
        self.units = (paneltiles.unit_tables(pack.xcols, kcount, self.rlm,
                                             shape[0], union=True)
                      if self.split else
                      paneltiles.unit_tables_for(pack.xcols, kcount,
                                                 self.rlm, self.c))
        # fused re/im rows: [ntiles, 2*rlm, ku*LM]
        if dev.type == "cuda":
            self.a_dm = torch.cat([a_re.transpose(1, 2), a_im.transpose(1, 2)],
                                  dim=2).contiguous()
            self.a_fused = self.a_dm.transpose(1, 2)
            if self.split:
                self.split_ops = paneltiles.SplitOperands(
                    self.units, self.a_fused, self.mode, self.lm, self.c,
                    self.x_mb * self.lm, shape[1])
            self.launch_tables = paneltiles.PanelLaunch(
                self.units, self.lm, self.c, dev, slots, shape=shape)
        else:
            self.a_fused = torch.cat([a_re, a_im], dim=1).contiguous()
        self.xcols = torch.from_numpy(
            np.ascontiguousarray(pack.xcols, dtype=np.int32)).to(dev)
        self.mask = torch.from_numpy(
            np.ascontiguousarray(mask, dtype=np.uint8)).to(dev)
        self.mask4 = self.mask.to(torch.float32)[:, None, :, None]

    @property
    def device(self) -> torch.device:
        return self.a_fused.device

    def _check(self, x: Pair):
        shape = (self.x_mb * self.lm, self.ncc, self.ln)
        for t in x:
            if (t.device != self.device or t.dtype != torch.float32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"x panels must be contiguous {shape} float32 tensors on "
                    f"{self.device}; got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")

    def plain(self, x: Pair) -> Pair:
        """The plain PyTorch version, on any device: gather the tiles'
        union rows, one ``torch.bmm`` against the fused panels (or the
        split mode's products), combine, cut to ``nr`` rows and mask."""
        from .panel import apply_mask

        nt, rlm, c = self.ntiles, self.rlm, self.c
        kulm = self.ku * self.lm
        xs = torch.cat([x[0].reshape(self.x_mb, self.lm, c),
                        x[1].reshape(self.x_mb, self.lm, c)], dim=2)
        xs = xs[self.xcols.to(torch.int64)].reshape(nt, kulm, 2 * c)
        d = (split_product(self.a_fused, xs, self.mode)
             if self.split else torch.bmm(self.a_fused, xs))  # [nt, 2rlm, 2c]
        d_r, d_i = d[..., :c], d[..., c:]        # [ar; ai] @ xr, [ar; ai] @ xi
        y_re = (d_r[:, :rlm] - d_i[:, rlm:]).reshape(nt * rlm, c)[:self.nr]
        y_im = (d_i[:, :rlm] + d_r[:, rlm:]).reshape(nt * rlm, c)[:self.nr]
        shape = (self.nr, self.ncc, self.ln)
        return apply_mask((y_re.reshape(shape), y_im.reshape(shape)),
                          self.mask4, self.mb, self.lm, self.ncc, self.ln)

    def __call__(self, x: Pair) -> Pair:
        self._check(x)
        if self.device.type == "cpu":
            return self.plain(x)
        if self.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no row-tile kernel for {self.device}")
        return self._launch(x)

    def _launch(self, x: Pair) -> Pair:
        from .._build import load_kernels

        return self.launch_with(load_kernels(), x)

    def launch_with(self, lib, x: Pair) -> Pair:
        """Launch through the kernel library ``lib``: the built one, or
        another build of the sources (``tools/kernel_compare.py``)."""
        shape = (self.nr, self.ncc, self.ln)
        y_re, y_im = x[0].new_empty(shape), x[1].new_empty(shape)
        lt = self.launch_tables
        ptrs = (x[0].data_ptr(), x[1].data_ptr(), self.mask.data_ptr(),
                y_re.data_ptr(), y_im.data_ptr())
        dims = (self.ntiles, self.rlm, self.ku, self.lm, self.nr, self.c,
                self.ln, self.units.nt, self.units.ksteps, lt.bm, lt.bn)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            if self.split:
                ops, mode = self.split_ops, SPLIT_PRODUCTS[self.mode]
                tables, nctas = lt.args(
                    lambda *shp: lib.tfq_rowtile_spmm_bf16_slots(*shp, mode))
                uslot, _, ucount, items, cta_start = tables
                ops.xsplit(x[0].view(-1, self.c), x[1].view(-1, self.c), lib)
                rc = lib.tfq_rowtile_spmm_bf16(
                    ops.maps(lib), *ptrs[2:], uslot, ucount,
                    ops.abase.data_ptr(), items, cta_start, nctas,
                    self.ntiles, self.rlm, self.lm, self.nr, self.c, self.ln,
                    self.units.nt, self.units.ksteps, lt.bm, lt.bn, ops.kc,
                    mode, stream,
                    launch_counts.pointer(self.device, "k3_split"))
            else:
                tables, nctas = lt.args(lib.tfq_rowtile_spmm_slots)
                rc = lib.tfq_rowtile_spmm_f32(
                    self.a_dm.data_ptr(), *ptrs, *tables, nctas, *dims,
                    stream, launch_counts.pointer(self.device, "k3"))
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"row-tile kernel ({self.mode}) returned "
                                f"{rc}")
        return y_re, y_im


def flops_bsr_panel(ntiles: int, rlm: int, kulm: int, c: int) -> float:
    """Flops of one packed multiply (padding included)."""
    return 8.0 * ntiles * rlm * kulm * c

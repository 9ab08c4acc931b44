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

cut to ``nr`` rows and masked to X's pattern.  FP32 only, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..errors import Status, TfqmrgpuError, encode_status
from . import paneltiles

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


class RowTileMultiply:
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
    mask's rows.  ``launches`` counts the kernel's launches by every
    instance in this process; the plain version never adds to it.
    """

    launches: int = 0

    def __init__(self, pack: RowTilePack, a_re: torch.Tensor,
                 a_im: torch.Tensor, mask: np.ndarray, ln: int,
                 slots: int = None, x_rows: int = None):
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
        self.units = paneltiles.unit_tables_for(pack.xcols, kcount, self.rlm,
                                                self.c)
        # fused re/im rows: [ntiles, 2*rlm, ku*LM]
        if dev.type == "cuda":
            self.a_dm = torch.cat([a_re.transpose(1, 2), a_im.transpose(1, 2)],
                                  dim=2).contiguous()
            self.a_fused = self.a_dm.transpose(1, 2)
            self.launch_tables = paneltiles.PanelLaunch(
                self.units, self.lm, self.c, dev, slots)
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
        union rows, one ``torch.bmm`` against the fused panels, combine,
        cut to ``nr`` rows and mask."""
        from .panel import apply_mask

        nt, rlm, c = self.ntiles, self.rlm, self.c
        kulm = self.ku * self.lm
        xs = torch.cat([x[0].reshape(self.x_mb, self.lm, c),
                        x[1].reshape(self.x_mb, self.lm, c)], dim=2)
        xs = xs[self.xcols.to(torch.int64)].reshape(nt, kulm, 2 * c)
        d = torch.bmm(self.a_fused, xs)          # [nt, 2*rlm, 2*c]
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
        with torch.cuda.device(self.device):
            tables, nctas = lt.args(lib.tfq_rowtile_spmm_slots)
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = lib.tfq_rowtile_spmm_f32(
                self.a_dm.data_ptr(), x[0].data_ptr(), x[1].data_ptr(),
                self.mask.data_ptr(), y_re.data_ptr(), y_im.data_ptr(),
                *tables, nctas, self.ntiles, self.rlm, self.ku, self.lm,
                self.nr, self.c, self.ln, self.units.nt, self.units.ksteps,
                lt.bm, lt.bn, stream)
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"row-tile kernel returned {rc}")
        RowTileMultiply.launches += 1
        return y_re, y_im


def flops_bsr_panel(ntiles: int, rlm: int, kulm: int, c: int) -> float:
    """Flops of one packed multiply (padding included)."""
    return 8.0 * ntiles * rlm * kulm * c

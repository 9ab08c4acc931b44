"""The 'pairs' engine: the pair-table multiply (K1) and the packed pair
plan of the 'c' solve (host packing, column grouping, fused-panel vectors
and K2).  Counterpart of ``tfqmrgpu_tpu/ops/pairpanel.py``; the function
names are the JAX package's.

**'z' (K1).**  ``PairPlanMultiply`` wraps ``csrc/pairpanel_spmm.cu``, which
computes what the TPU kernel ``_make_call.kernel`` (line 1770) computes,

    Y[iY] = sum_{p in [starts[iY], starts[iY+1])}  A[pair_a[p]] @ X[pair_x[p]]

on the vectors' own (re, im) block planes, in native FP64 (the H100 has
it; the TPU needed Ozaki slices).  In 'z' the kernel runs a plan-time tile
schedule (``tile_schedule``: tiles of R block rows x W block columns, each
A and X block staged once per tile) on the FP64 tensor cores; in 'c' it
walks the pair table itself.  ``spmm_schedule`` is the schedule's plain
walker, for the tests.

**'c' (K2).**  As in the JAX package, the pair list is packed once on the
host (pattern only):

1. ``pack_grouped``: G compressed columns side by side on the lane axis
   (LN' = G*LN), so that one streamed A block serves all G; the pair list
   is deduplicated over (A block, row, group) cells.  ``auto_group_size``
   picks G from a full-iteration model at the card's rates.
2. ``pack_pair_plan``: Cuthill-McKee relabelling of the cells (column-major,
   rows in CM order), tiles of ``r_tile`` cells, each tile's union of X
   cells padded to ``ku`` and its A blocks scattered into a fused panel
   [2*r_tile*LM, ku*LM] (re rows over im rows).  Only the TPU's *resident*
   layout is ported: X is one window over all slots, so ``xloc`` holds
   absolute slot ids; on the card X lives in device memory whatever its
   size.  The TPU's VMEM windows, copy-code programs and step tables are
   not ported.
3. Vectors live as fused permuted panels [n_slots*LM, 2*LN'] (re lanes
   [:LN'], im lanes [LN':]); ``fused_primitives`` does the tfQMR vector
   work there, and the multiply is ``PairPanelMultiply`` (K2,
   ``csrc/pairpanel_tiles.cu``), the counterpart of ``kernel_tile_pipe``
   (line 1706), followed by the grouped lane mask.

At LM <= 8 the solver may merge block rows into superblocks before
packing (``ops/superblock.py``, ``solver.pack_superblock``): the packed
plan is then the merged one, at LM' = f*LM, and ``fused_primitives``
masks every product to its live slots (``sup_mask``).

**'z' on the packed plan (the oz kernel).**  Under TFQ_PAIRS_Z_OZ=1 the
solver runs 'z' as the JAX package does, on the packed plan with float64
fused panels: ``make_pairpanel_multiply_oz`` cuts A and X into Ozaki slices
and ``OzPairPanelMultiply`` runs ``csrc/pairpanel_oz.cu``, the counterpart
of the Ozaki branches of ``_make_call.kernel``, on the INT8 and BF16
tensor cores (see the section "K1's Ozaki modes").
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import os
from collections import deque
from math import comb
from typing import Optional

import numpy as np
import torch

from .. import launch_counts
from ..errors import Status, TfqmrgpuError, encode_status
from ..profiling import trace
from . import ozaki, paneltiles
from .blocksparse import spmm_pairs

Pair = tuple

# The (LM, LN) pairs the kernels are compiled for: the reference's list
# (allowed_block_sizes.h:4-18).
KERNEL_BLOCK_SIZES = (
    (4, 4), (4, 5), (4, 8), (4, 32),
    (8, 8), (8, 9), (8, 10), (8, 32), (8, 64),
    (16, 16), (16, 32), (16, 64),
    (32, 32), (32, 64),
    (64, 64),
)

_ENTRY = {torch.float64: "tfq_pairpanel_spmm_f64",
          torch.float32: "tfq_pairpanel_spmm_f32"}

# The rates of the group-size model (auto_group_size), the card's own: the
# device-memory rate the K4 stream probe (dma_probe.py) measured through
# shared memory on an H100 80GB HBM3 at 700 W, for the A stream and the
# vector passes alike, and NVIDIA's FP32 peak of the H100 SXM outside the
# tensor cores, for the product.
STREAM_BYTES_PER_S = 2.65e12
FP32_FLOPS_PER_S = 67e12
# estimates within this relative margin of the best tie; the larger G wins
GROUP_TIE = 1e-3


# ================================================= the precision modes of 'c'
#
# The packed 'c' engine's K2 and the row tiles' K3 run one of the JAX
# package's matmul precisions: 'highest' (exact FP32, the default) or a
# bf16 split mode, in which every float32 operand is split into bf16 planes
# and the product is a sum of bf16 plane products.  On the card the split
# modes run on the BF16 tensor cores (csrc/panel_mma.cuh), each with exactly
# the products of the TPU kernels' dots.  The solver reads TFQ_PAIRS_MM_PREC
# for K2 and TFQ_PALLAS_MM_PREC for K3, as the JAX package does.

PRECISIONS = ("bf16", "bf16x3", "bf16x4", "bf16x6", "highest")
# modes whose X windows are bf16 splits (the JAX kernel needs LM >= 16)
SPLIT_X_PRECISIONS = ("bf16", "bf16x3", "bf16x4", "bf16x6")
# bf16 products a split mode takes per float32 product: the divisor of the
# card's BF16 peak in profiling.solver_roofline (the JAX package's
# ``passes`` count MXU passes instead)
SPLIT_PRODUCTS = {"bf16": 1, "bf16x3": 3, "bf16x4": 4, "bf16x6": 6}
FLT_MIN = float(np.finfo(np.float32).tiny)      # the least normal float32
# the (A plane, X plane) products of each mode, in the order the split
# kernel (csrc/panel_mma.cuh) sums them for K2 and K3 alike: the order of
# K2's TPU dots (pairpanel.py:1663-1693).  K3's TPU kernel takes bf16x6's
# six in another order (pallas_spmm.py:244-254); the products are exact,
# so the orders differ by float32 rounding only.
SPLIT_TERMS = {"bf16": ((0, 0),),
               "bf16x3": ((0, 0), (0, 1), (1, 0)),
               "bf16x4": ((0, 0), (0, 1), (1, 0), (1, 1)),
               "bf16x6": ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))}


def precision_props(precision: str) -> dict:
    """Shape and cost properties of a precision mode, the JAX package's
    (its pairpanel.py:531-579): ``xsplit`` bf16 planes of X (1: raw
    float32), ``a_presplit`` bf16 planes A ships as (0: raw float32),
    ``passes`` the TPU's MXU pass-equivalents a product.  The Ozaki modes
    'ozcN' and 'ozN' (N slices) add ``a_bytes``, the bytes of one A slice
    entry (1 for int8 planes under TFQ_OZC_INT8 / TFQ_OZ_INT8, else 2),
    and 'ozcN' ``comp``.  Any other string raises KeyError, as an unknown
    one does there."""
    if precision.startswith("ozc"):
        p = int(precision[3:])
        a_b = 1 if os.environ.get("TFQ_OZC_INT8", "0") != "0" else 2
        return dict(xsplit=p, a_presplit=p, passes=p * (p + 1) / 4.0,
                    a_bytes=a_b, comp=True)
    if precision.startswith("oz"):
        p = int(precision[2:])
        a_b = 1 if os.environ.get("TFQ_OZ_INT8", "1") != "0" else 2
        return dict(xsplit=p, a_presplit=p, passes=p * (p + 1) / 4.0,
                    a_bytes=a_b)
    return {
        "highest": dict(xsplit=1, a_presplit=0, passes=6.0),
        "bf16":    dict(xsplit=2, a_presplit=2, passes=1.0),
        "bf16x3":  dict(xsplit=2, a_presplit=2, passes=3.0),
        "bf16x4":  dict(xsplit=2, a_presplit=2, passes=4.0),
        "bf16x6":  dict(xsplit=3, a_presplit=0, passes=4.0),
    }[precision]


def check_precision(precision: str) -> str:
    """``precision`` if it is one of ``PRECISIONS``, else ValueError (the
    JAX row-tile kernel runs 'highest' for an unknown string instead)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return precision


def rn16_f32(v: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to the nearest bf16-representable value,
    returned as float32, by the JAX package's mantissa mask: add 0x8000 to
    the bits and keep the upper 16 (ties away from zero; a value within
    2^-8 of the float32 maximum rounds to infinity).  Not
    ``.to(torch.bfloat16)``, which breaks ties to even."""
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    r = (bits + 0x8000) & 0xFFFF0000
    r = r - ((r >> 31) << 32)                 # back into int32's range
    return r.to(torch.int32).view(torch.float32)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """float32 subnormals to zero of the same sign."""
    return torch.where(v.abs() < FLT_MIN, v * 0.0, v)


def _sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b as XLA computes it on the CPU (and the TPU): subnormal
    operands read as zero and a subnormal difference is flushed to zero.
    The split residuals use it, so that the planes are the JAX package's to
    the bit."""
    return _flush(_flush(a) - _flush(b))


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16, rounded to nearest even as XLA converts; a NaN
    keeps the upper half of its float32 bits (quieted), as XLA keeps it."""
    nan = ((v.contiguous().view(torch.int32) >> 16) | 0x40).to(torch.int16)
    return torch.where(torch.isnan(v), nan.view(torch.bfloat16),
                       v.to(torch.bfloat16))


def split_bf16x2(a: torch.Tensor) -> tuple:
    """(hi, lo) bfloat16 planes of a float32 tensor, a == hi + lo +
    O(2^-16): hi by ``rn16_f32``, lo the residual rounded to nearest even."""
    hi_f32 = rn16_f32(a)
    return hi_f32.to(torch.bfloat16), _bf16(_sub(a, hi_f32))


def split_bf16x3(a: torch.Tensor) -> tuple:
    """(hi, mid, lo) bfloat16 planes of a float32 tensor, a == hi + mid +
    lo + O(2^-25): hi and mid by ``rn16_f32``, lo rounded to nearest even."""
    hi_f32 = rn16_f32(a)
    r1 = _sub(a, hi_f32)
    mid_f32 = rn16_f32(r1)
    return (hi_f32.to(torch.bfloat16), mid_f32.to(torch.bfloat16),
            _bf16(_sub(r1, mid_f32)))


def split_planes(v: torch.Tensor, precision: str) -> tuple:
    """The bf16 planes of a split mode as float32 tensors: hi alone for
    'bf16' (the JAX kernel multiplies the hi half only), (hi, lo) for
    'bf16x3' and 'bf16x4', (hi, mid, lo) for 'bf16x6'."""
    if precision == "bf16":
        return (rn16_f32(v),)
    parts = split_bf16x3(v) if precision == "bf16x6" else split_bf16x2(v)
    return tuple(t.to(torch.float32) for t in parts)


def split_product(a: torch.Tensor, x: torch.Tensor,
                  precision: str) -> torch.Tensor:
    """``a @ x`` (batched float32) in a split mode: the products
    ``SPLIT_TERMS[precision]`` of the operands' bf16 planes, each a float32
    ``torch.matmul``, summed left to right in the split kernel's order.  Every
    product is exact in float32 (8-bit by 8-bit significands); TF32 must be
    off, as for the dense engine."""
    from .panel import _refuse_tf32

    _refuse_tf32()
    ap, xp = split_planes(a, precision), split_planes(x, precision)
    y = None
    for i, j in SPLIT_TERMS[precision]:
        d = torch.matmul(ap[i], xp[j])
        y = d if y is None else y + d
    return y


# ======================================================= K1's tile schedule
#
# In 'z' a CTA of K1 owns a tile of Y blocks: R consecutive block rows x W
# consecutive compressed columns.  Y index = X index, so Y block (i, c) is
# X block (i, c).  Step k of a tile multiplies the A blocks (i, k) of its
# rows, stacked into an [R*LM, LM] slice, with the X blocks (k, c) of its
# columns, side by side in an [LM, W*LN] slice: one dense product into the
# tile's [R*LM, W*LN] accumulators, with absent blocks staged as zeros.  A
# block (i, k) belongs to one row and one k, and X block (k, c) to one k and
# one column, so each is staged once per tile.  Because create_plan's pair
# list is the full intersection of the patterns (pair (A(i,k), X(k,c))
# exists for Y (i,c) whenever all three blocks do), the step's products are
# exactly the plan's pairs; ``build_tile_schedule`` checks that and raises
# for a table that is not such a list.

# Streaming multiprocessors the shape rule fills with two tiles each before
# it makes tiles larger: the H100 SXM's, for a schedule built off the card;
# on the card the wrapper passes the device's own count.
SM_COUNT = 132
# Warps of one K1 CTA in 'z'.  At 64 accumulators a thread, two CTAs of four
# warps fill an SM's registers, and one CTA's waits at its barriers overlap
# the other's products.
MAX_WARPS = 4
Z_BYTES = 16                      # bytes of one complex128 element


def warp_tile(lm: int, ln: int) -> tuple:
    """(rows, columns) of one warp's part of a K1 'z' tile: whole m16 x n8
    MMA fragments, at most 32 x 32 (64 accumulators per thread).  The same
    rule as ``TileGeo`` in ``csrc/pairpanel_spmm.cu``."""
    return (32 if lm >= 32 else 16,
            32 if ln >= 32 else -(-ln // 8) * 8)


@dataclasses.dataclass
class TileSchedule:
    """K1's plan-time tile schedule ('z'), host numpy tables.

    Tile t owns Y slots ``tile_y[t, r*W + w]`` (Y block of its row r and
    column w, or -1) and runs steps ``tile_steps[t]:tile_steps[t+1]`` in
    ascending k; step s stages A blocks ``step_a[s, r]`` and X blocks
    ``step_x[s, w]`` (-1: absent, staged as zeros); bit r of
    ``step_mask[s]`` says that A slot r is present.  Step s adds
    A[step_a[s, r]] @ X[step_x[s, w]] to Y slot (r, w) wherever all three
    are present: those are exactly the plan's pairs."""

    lm: int
    ln: int
    warps_m: int
    warps_n: int
    rows: int                # R: block rows of a tile
    cols: int                # W: block columns of a tile
    tile_steps: np.ndarray   # int32[ntiles + 1]
    tile_y: np.ndarray       # int32[ntiles, R*W]
    step_a: np.ndarray       # int32[nsteps, R]
    step_x: np.ndarray       # int32[nsteps, W]
    step_mask: np.ndarray    # uint64[nsteps]
    staged_bytes: int        # complex128 bytes copied to shared memory per multiply

    @property
    def ntiles(self) -> int:
        return int(self.tile_y.shape[0])

    @property
    def nsteps(self) -> int:
        return int(self.step_a.shape[0])

    def products(self) -> tuple:
        """(A block, X block, Y block) of every product the schedule runs,
        in tile, step, row, column order."""
        r_, w_ = self.rows, self.cols
        tile = np.repeat(np.arange(self.ntiles), np.diff(self.tile_steps))
        ys = self.tile_y[tile].reshape(-1, r_, w_)
        s, r, w = np.nonzero((self.step_a >= 0)[:, :, None]
                             & (self.step_x >= 0)[:, None, :] & (ys >= 0))
        return (self.step_a[s, r].astype(np.int64),
                self.step_x[s, w].astype(np.int64),
                ys[s, r, w].astype(np.int64))


def warp_grids(lm: int, ln: int) -> list:
    """Every (warps_m, warps_n) grid of one to ``MAX_WARPS`` warps whose tile
    holds whole block rows (R = warps_m*WTM/LM) and at least one block
    column (W = warps_n*WTN // LN), largest first."""
    wtm, wtn = warp_tile(lm, ln)
    return [(warps // wn, wn)
            for warps in (4, 2, 1) for wn in (1, 2, 4)
            if wn <= warps and warps // wn * wtm % lm == 0
            and wn * wtn // ln >= 1]


def tile_shapes(lm: int, ln: int, nrows: int, ncols: int) -> list:
    """``warp_grids`` less the grids whose half already spans every row or
    column of an nrows x ncols pattern."""
    wtm, wtn = warp_tile(lm, ln)

    def rows(wm):   # block rows of a tile wm warps tall; 0 if it splits one
        return wm * wtm // lm if wm * wtm % lm == 0 else 0

    return [(wm, wn) for wm, wn in warp_grids(lm, ln)
            if not (wm > 1 and rows(wm // 2) >= max(nrows, 1))
            and not (wn > 1 and wn // 2 * wtn // ln >= ncols)]


def build_tile_schedule(rowptr_x, colindx, starts, pairs, lm: int, ln: int,
                        shape: tuple, x_rows=None,
                        x_cols=None) -> TileSchedule:
    """K1's tile schedule for the warp grid ``shape`` = (warps_m, warps_n).

    ``rowptr_x`` and ``colindx`` give every Y block's row and compressed
    column; ``starts`` and ``pairs`` are the pair table.  ``x_rows`` and
    ``x_cols`` give every X block's row and column where the X side is not
    the Y side (a shard reads a gathered X: ``PairTable``); by default X is
    Y, as in a plan.  Raises ValueError for a grid that does not fit
    (LM, LN) or a pair table that is not the full intersection create_plan
    builds."""
    warps_m, warps_n = (int(v) for v in shape)
    if (warps_m, warps_n) not in warp_grids(lm, ln):
        raise ValueError(f"warp grid {shape} does not fit ({lm}, {ln})")
    wtm, wtn = warp_tile(lm, ln)
    r_, w_ = warps_m * wtm // lm, warps_n * wtn // ln
    rowptr_x = np.asarray(rowptr_x, np.int64)
    col = np.asarray(colindx, np.int64)
    starts = np.asarray(starts, np.int64)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    nrows, nnzb = rowptr_x.shape[0] - 1, col.shape[0]
    row = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(rowptr_x))
    if row.shape[0] != nnzb or starts.shape[0] != nnzb + 1:
        raise ValueError("rowptr_x, colindx and starts disagree on nnzb")
    row_x = row if x_rows is None else np.asarray(x_rows, np.int64)
    col_x = col if x_cols is None else np.asarray(x_cols, np.int64)
    if row_x.shape != col_x.shape:
        raise ValueError("x_rows and x_cols disagree on the X blocks")
    ntc = -(-(int(col.max()) + 1 if nnzb else 0) // w_)

    _, tile_of_y = np.unique((row // r_) * ntc + col // w_,
                             return_inverse=True)
    ntiles = int(tile_of_y.max()) + 1 if nnzb else 0
    tile_y = np.full((ntiles, r_ * w_), -1, np.int64)
    tile_y[tile_of_y, (row % r_) * w_ + col % w_] = np.arange(nnzb)
    if np.count_nonzero(tile_y >= 0) != nnzb:
        raise ValueError("two Y blocks share a (row, column)")

    pa, px = pairs[:, 0], pairs[:, 1]
    py = np.repeat(np.arange(nnzb, dtype=np.int64), np.diff(starts))
    if np.any(col_x[px] != col[py]):
        raise ValueError("a pair's X block lies outside its Y block's column")
    steps, step_of = np.unique(tile_of_y[py] * nrows + row_x[px],
                               return_inverse=True)
    nsteps = steps.shape[0]
    step_tile = steps // nrows
    r, w = row[py] % r_, col[py] % w_
    step_a = np.full((nsteps, r_), -1, np.int64)
    step_x = np.full((nsteps, w_), -1, np.int64)
    step_a[step_of, r] = pa
    step_x[step_of, w] = px
    va, vx = step_a >= 0, step_x >= 0
    implied = np.count_nonzero(
        va[:, :, None] & vx[:, None, :]
        & (tile_y[step_tile] >= 0).reshape(nsteps, r_, w_))
    distinct = np.unique((step_of * r_ + r) * w_ + w).shape[0]
    if (np.any(step_a[step_of, r] != pa) or np.any(step_x[step_of, w] != px)
            or distinct != pa.shape[0] or implied != pa.shape[0]):
        raise ValueError("the pair table is not the full pattern "
                         "intersection create_plan builds")
    mask = np.bitwise_or.reduce(
        va.astype(np.uint64) << np.arange(r_, dtype=np.uint64), axis=1)
    staged = Z_BYTES * (int(va.sum()) * lm * lm + int(vx.sum()) * lm * ln)
    return TileSchedule(
        lm=lm, ln=ln, warps_m=warps_m, warps_n=warps_n, rows=r_, cols=w_,
        tile_steps=np.searchsorted(step_tile, np.arange(ntiles + 1)).astype(
            np.int32),
        tile_y=tile_y.astype(np.int32), step_a=step_a.astype(np.int32),
        step_x=step_x.astype(np.int32), step_mask=mask.astype(np.uint64),
        staged_bytes=staged)


@dataclasses.dataclass
class PairTable:
    """The tables K1 reads: a pair table and the patterns of its two sides.

    A plan's table multiplies X into the Y of X's own pattern
    (``from_plan``).  A shard's table (``parallel/sharded.py``) writes the
    shard's own Y blocks from X blocks of every row shard, gathered into
    one array, so its X side has its own count, rows and columns.
    ``starts`` and ``pairs`` live on the device, the patterns on the host.
    """

    starts: torch.Tensor      # int32[nnzb_y + 1]
    pairs: torch.Tensor       # int32[nPairs, 2]: (A block, X block), Y order
    nnzb_a: int
    nnzb_x: int
    nrows: int                # block rows of the operator
    rowptr_y: np.ndarray      # int64[nrows + 1]: the Y blocks, by row
    y_cols: np.ndarray        # int[nnzb_y]: each Y block's compressed column
    x_rows: Optional[np.ndarray] = None   # int[nnzb_x]; None: X is Y
    x_cols: Optional[np.ndarray] = None

    @classmethod
    def from_plan(cls, plan) -> "PairTable":
        return cls(starts=plan.starts, pairs=plan.pairs, nnzb_a=plan.nnzb_a,
                   nnzb_x=plan.nnzb_x, nrows=plan.nrows,
                   rowptr_y=plan.rowptr_x,
                   y_cols=plan.colindx.cpu().numpy())

    @property
    def nnzb_y(self) -> int:
        return int(self.starts.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.starts.device

    def pair_y(self) -> torch.Tensor:
        """int64[nPairs]: the Y block of every pair (ascending)."""
        counts = (self.starts[1:] - self.starts[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self.nnzb_y, device=self.device), counts)


def tile_schedule(plan, lm: int, ln: int, grid: tuple = None,
                  sm_count: int = SM_COUNT) -> TileSchedule:
    """The schedule K1 runs for ``plan`` (a plan or a ``PairTable``) in
    'z': under the warp grid ``grid`` if one is given, else by the rule.
    The rule: the most warps per tile whose tiles still fill every one of
    ``sm_count`` SMs twice, the fewest if none does; of the grids of that
    many warps (tiles of the same area), the one with the fewest steps,
    that is the least padded product work, then the fewest staged bytes."""
    t = plan if isinstance(plan, PairTable) else PairTable.from_plan(plan)
    col = t.y_cols
    args = (t.rowptr_y, col, t.starts.cpu().numpy(), t.pairs.cpu().numpy(),
            lm, ln)
    sides = dict(x_rows=t.x_rows, x_cols=t.x_cols)
    if grid is not None:
        return build_tile_schedule(*args, grid, **sides)
    ncols = int(col.max()) + 1 if col.size else 0
    cands = [build_tile_schedule(*args, shape, **sides)
             for shape in tile_shapes(lm, ln, t.nrows, ncols)]
    warps = max((s.warps_m * s.warps_n for s in cands
                 if s.ntiles >= 2 * sm_count),
                default=min(s.warps_m * s.warps_n for s in cands))
    return min((s for s in cands if s.warps_m * s.warps_n == warps),
               key=lambda s: (s.nsteps, s.staged_bytes))


def spmm_schedule(a: Pair, x: Pair, sched: TileSchedule, nnzb_y: int) -> Pair:
    """Plain PyTorch walk of K1's tile schedule: every product it lists,
    four real batched products and an ``index_add_`` into Y.  The tests
    hold the schedule against the JAX package with it; the main path never
    calls it."""
    dev = a[0].device
    ia, ix, iy = (torch.from_numpy(v).to(dev) for v in sched.products())
    return spmm_pairs(a, x, ia, ix, iy, nnzb_y)


# ================================================================ K1

class PairPlanMultiply(metaclass=launch_counts.CountedLaunches):
    """``y = A @ x`` over a plan's pair table, with A held on the device.

    ``plan`` is a plan, or a ``PairTable`` whose X side differs from its Y
    side (x then has ``nnzb_x`` blocks and y ``nnzb_y``).  In 'z' (float64)
    the kernel runs the table's tile schedule, built once here by
    ``tile_schedule`` (under the warp grid ``grid``, by default the rule's,
    for the SMs of A's device) and uploaded; in 'c' (float32) it walks the
    pair table itself.  On a CPU tensor the plain version (``spmm_pairs``)
    runs instead.

    ``launches`` reads the kernel's launch counter on the card (every
    instance's runs in this process, ``launch_counts``), so that a run can
    show that its multiplies went through the kernel; the plain version
    never adds to it.
    """

    _counters = {"launches": "k1"}

    def __init__(self, plan, a_re: torch.Tensor, a_im: torch.Tensor, ln: int,
                 grid: tuple = None):
        if not isinstance(plan, PairTable):
            with trace("pair_table"):
                plan = PairTable.from_plan(plan)
        self.lm = int(a_re.shape[1])
        self.ln = int(ln)
        self.nnzb_x, self.nnzb_y = plan.nnzb_x, plan.nnzb_y
        dev = a_re.device
        if a_re.dtype not in _ENTRY or a_im.dtype != a_re.dtype:
            raise TfqmrgpuError(encode_status(Status.PRECISION_MISSMATCH),
                                f"A planes of {a_re.dtype}/{a_im.dtype}")
        shape = (plan.nnzb_a, self.lm, self.lm)
        for name, t in (("a_re", a_re), ("a_im", a_im)):
            if tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {shape} tensor "
                                 f"on {dev}, got {tuple(t.shape)} on {t.device}")
        if plan.device != dev:
            raise ValueError(f"plan tables on {plan.device}, A on {dev}")
        if plan.starts.dtype != torch.int32 or plan.pairs.dtype != torch.int32:
            raise ValueError("the kernel reads int32 starts and pairs")
        if dev.type == "cuda" and (self.lm, self.ln) not in KERNEL_BLOCK_SIZES:
            raise TfqmrgpuError(
                encode_status(Status.BLOCKSIZE_MISSING),
                f"(LM, LN) = ({self.lm}, {self.ln}) is not among the "
                f"kernel's block sizes {KERNEL_BLOCK_SIZES}")
        self.a_re, self.a_im = a_re, a_im
        with trace("copies"):
            self.starts = plan.starts.contiguous()
            self.pair_a = plan.pairs[:, 0].contiguous()
            self.pair_x = plan.pairs[:, 1].contiguous()
        with trace("pair_y"):
            self.pair_y = plan.pair_y()
        self.schedule = None
        if a_re.dtype == torch.float64:
            sm_count = (torch.cuda.get_device_properties(dev)
                        .multi_processor_count if dev.type == "cuda"
                        else SM_COUNT)
            with trace("schedule") as span:
                s = tile_schedule(plan, self.lm, self.ln, grid, sm_count)
            if span is not None:      # what the trace shows of the tiles
                span.attrs.update(
                    grid=(s.warps_m, s.warps_n), tiles=s.ntiles,
                    steps=s.nsteps, staged_bytes=s.staged_bytes,
                    pairs=int(plan.pairs.shape[0]))
            self.schedule = s
            with trace("schedule_upload", dev):
                self._tables = tuple(
                    torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                    for t in (s.tile_steps, s.tile_y, s.step_a, s.step_x,
                              s.step_mask.view(np.int64)))
        elif grid is not None:
            raise ValueError("a warp grid applies to the 'z' kernel only")

    @property
    def device(self) -> torch.device:
        return self.a_re.device

    def _check(self, x: Pair):
        shape = (self.nnzb_x, self.lm, self.ln)
        for t in x:
            if (t.device != self.device or t.dtype != self.a_re.dtype
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"x planes must be contiguous {shape} {self.a_re.dtype} "
                    f"tensors on {self.device}; got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")

    def plain(self, x: Pair) -> Pair:
        """The plain PyTorch version on the same tables, on any device."""
        return spmm_pairs((self.a_re, self.a_im), x, self.pair_a,
                          self.pair_x, self.pair_y, self.nnzb_y)

    def __call__(self, x: Pair) -> Pair:
        self._check(x)
        if self.device.type == "cpu":
            return self.plain(x)
        if self.nnzb_y == 0:                  # a shard without Y blocks
            return tuple(t.new_empty((0, self.lm, self.ln)) for t in x)
        if self.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no pair-plan kernel for {self.device}")
        return self._launch(x)

    def _launch(self, x: Pair) -> Pair:
        from .._build import load_kernels

        fn = getattr(load_kernels(), _ENTRY[self.a_re.dtype])
        y_re = x[0].new_empty((self.nnzb_y, self.lm, self.ln))
        y_im = x[1].new_empty((self.nnzb_y, self.lm, self.ln))
        planes = (self.a_re, self.a_im, x[0], x[1])
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            count = launch_counts.pointer(self.device, "k1")
            s = self.schedule
            if s is None:
                rc = fn(*(t.data_ptr() for t in planes),
                        self.starts.data_ptr(), self.pair_a.data_ptr(),
                        self.pair_x.data_ptr(), y_re.data_ptr(),
                        y_im.data_ptr(), self.nnzb_y, self.lm, self.ln,
                        stream, count)
            elif any(t.data_ptr() % 16 for t in planes):
                raise ValueError("the 'z' kernel copies A and x in 16-byte "
                                 "pieces: their planes must be 16-byte "
                                 "aligned")
            else:
                rc = fn(*(t.data_ptr() for t in planes + self._tables),
                        y_re.data_ptr(), y_im.data_ptr(), s.ntiles, self.lm,
                        self.ln, s.warps_m, s.warps_n, s.rows, s.cols,
                        stream, count)
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"pair-plan kernel returned {rc}")
        return y_re, y_im


# ================================================= geometry and relabelling

def _find(par: np.ndarray, i: int) -> int:
    r = i
    while par[r] != r:
        r = par[r]
    while par[i] != r:
        par[i], i = r, par[i]
    return int(r)


def recover_geometry(pair_a, pair_x, pair_y, nnzb_y: int):
    """Recover (row_fragment, column) labels of the shared X/Y pattern space
    from a bare pair list.  Returns (frag[nnzb_y], col[nnzb_y])."""
    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    n = pa.shape[0]

    def _union(par, a, b):
        ra, rb = _find(par, int(a)), _find(par, int(b))
        if ra != rb:
            par[ra] = rb

    par = np.arange(nnzb_y)
    o = np.argsort(pa, kind="stable")
    pa_s, py_s, px_s = pa[o], py[o], px[o]
    i = 0
    while i < n:
        j = i + 1
        while j < n and pa_s[j] == pa_s[i]:
            j += 1
        for t in range(i + 1, j):
            # one A block: its Y blocks share a block row, and so do its
            # X blocks (the A block's column is one row index)
            _union(par, py_s[i], py_s[t])
            _union(par, px_s[i], px_s[t])
        i = j
    frag = np.fromiter((_find(par, i) for i in range(nnzb_y)), np.int64,
                       nnzb_y)
    _, frag = np.unique(frag, return_inverse=True)

    par = np.arange(nnzb_y)
    for t in range(n):
        _union(par, py[t], px[t])
    col = np.fromiter((_find(par, i) for i in range(nnzb_y)), np.int64,
                      nnzb_y)
    _, col = np.unique(col, return_inverse=True)
    return frag, col


def _cuthill_mckee(nfrag: int, edges_a: np.ndarray, edges_b: np.ndarray):
    """BFS (Cuthill-McKee) ordering of the fragment graph -> rank[nfrag]."""
    adj = [set() for _ in range(nfrag)]
    for a, b in zip(edges_a, edges_b):
        if a != b:
            adj[a].add(int(b))
            adj[b].add(int(a))
    order = []
    seen = np.zeros(nfrag, bool)
    deg = np.array([len(s) for s in adj])
    for s in np.argsort(deg):
        if seen[s]:
            continue
        seen[s] = True
        dq = deque([int(s)])
        while dq:
            u = dq.popleft()
            order.append(u)
            for v in sorted(adj[u], key=lambda v: len(adj[v])):
                if not seen[v]:
                    seen[v] = True
                    dq.append(v)
    rank = np.zeros(nfrag, np.int64)
    rank[np.array(order)] = np.arange(nfrag)
    return rank


def _labels(pa, px, py, nnzb, row_of, col_of):
    """(row, col) labels: recovered from the pair list unless given."""
    if row_of is None or col_of is None:
        return recover_geometry(pa, px, py, nnzb)
    _, row = np.unique(np.asarray(row_of, np.int64), return_inverse=True)
    _, col = np.unique(np.asarray(col_of, np.int64), return_inverse=True)
    return row, col


# ==================================================================== pack

@dataclasses.dataclass
class PairPanelPlan:
    """A packed resident pair plan (pattern only; data enters via panels).
    The tables are the JAX package's ``pack_pair_plan(..., resident=True)``
    tables of the same names."""

    ntiles: int
    r_tile: int
    ku: int                  # union X slots per tile (max, rounded to even)
    lm: int
    ln: int                  # lanes of one plane (G*LN when grouped)
    nnzb_y: int
    nnzb_x: int
    n_slots: int             # relabelled slots (== nnzb_x)
    perm: np.ndarray         # int64[n_slots]: new slot -> old block
    inv_perm: np.ndarray     # int64[nnzb_x]: old block -> new slot
    xloc: np.ndarray         # int32[ntiles, ku]: the tile's union slots
    kcount: np.ndarray       # int32[ntiles]: true union size per tile
    # A panel scatter map: pair p -> panel[pair_tile, pair_rslot, pair_kslot]
    pair_tile: np.ndarray    # int32[nPairs]
    pair_rslot: np.ndarray   # int32[nPairs]
    pair_kslot: np.ndarray   # int32[nPairs]
    pair_a: np.ndarray       # int64[nPairs]: the pair's A block
    inflation: float         # padded block products / nPairs
    col_of_new: np.ndarray   # int64[n_slots]: column (or group) of each slot


def pack_pair_plan(pair_a, pair_x, pair_y, nnzb_y: int, nnzb_x: int,
                   lm: int, ln: int, r_tile: int = 2, row_of=None,
                   col_of=None) -> PairPanelPlan:
    """Compile a pair list into the resident union-ELL tile plan.

    row_of/col_of: the known geometry (from a BSR plan); recovered from the
    pair list if absent."""
    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    if nnzb_x != nnzb_y:
        raise ValueError("pair plans share one X/Y pattern space")
    frag, col = _labels(pa, px, py, nnzb_y, row_of, col_of)
    nfrag = int(frag.max()) + 1

    rank = _cuthill_mckee(nfrag, frag[py], frag[px])
    key = col * (nfrag + 1) + rank[frag]
    perm = np.argsort(key, kind="stable")          # new slot -> old block
    n_slots = nnzb_x
    inv = np.zeros(nnzb_x, np.int64)
    inv[perm] = np.arange(nnzb_x)

    npy, npx = inv[py], inv[px]                     # pairs in new labels
    order = np.argsort(npy, kind="stable")
    npy_s, npx_s, pa_s = npy[order], npx[order], pa[order]
    starts = np.searchsorted(npy_s, np.arange(n_slots + 1))

    ntiles = (n_slots + r_tile - 1) // r_tile
    unions = []
    ku = 1
    for t in range(ntiles):
        lo = starts[t * r_tile]
        hi = starts[min((t + 1) * r_tile, n_slots)]
        u = np.unique(npx_s[lo:hi])
        if u.shape[0] == 0:
            u = np.zeros(1, np.int64)
        unions.append(u)
        ku = max(ku, u.shape[0])
    ku += ku % 2               # even, as the JAX package's panels are

    xloc = np.zeros((ntiles, ku), np.int32)
    kcount = np.zeros(ntiles, np.int32)
    pair_kslot = np.zeros(npx_s.shape[0], np.int32)
    for t, u in enumerate(unions):
        xloc[t, : u.shape[0]] = u.astype(np.int32)
        kcount[t] = u.shape[0]
        lo = starts[t * r_tile]
        hi = starts[min((t + 1) * r_tile, n_slots)]
        pair_kslot[lo:hi] = np.searchsorted(u, npx_s[lo:hi]).astype(np.int32)
    return PairPanelPlan(
        ntiles=ntiles, r_tile=r_tile, ku=ku, lm=lm, ln=ln, nnzb_y=nnzb_y,
        nnzb_x=nnzb_x, n_slots=n_slots, perm=perm, inv_perm=inv, xloc=xloc,
        kcount=kcount, pair_tile=(npy_s // r_tile).astype(np.int32),
        pair_rslot=(npy_s % r_tile).astype(np.int32), pair_kslot=pair_kslot,
        pair_a=pa_s, inflation=float((ntiles * r_tile * ku) / max(len(pa), 1)),
        col_of_new=col[perm])


def build_a_panels(plan: PairPanelPlan, a_re: np.ndarray,
                   a_im: np.ndarray) -> np.ndarray:
    """Scatter A block data into fused panels [ntiles, 2*r_tile*LM, ku*LM]
    (re rows over im rows) on the host; duplicate pairs add up."""
    lm, r, ku = plan.lm, plan.r_tile, plan.ku
    flat = np.zeros((plan.ntiles * 2 * r * ku, lm, lm), dtype=a_re.dtype)
    base = (plan.pair_tile.astype(np.int64) * 2 * r
            + plan.pair_rslot) * ku + plan.pair_kslot
    np.add.at(flat, base, a_re[plan.pair_a])
    np.add.at(flat, base + r * ku, a_im[plan.pair_a])
    p = flat.reshape(plan.ntiles, 2 * r, ku, lm, lm).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(p.reshape(plan.ntiles, 2 * r * lm, ku * lm))


def build_a_panels_device(plan: PairPanelPlan, a_re: torch.Tensor,
                          a_im: torch.Tensor, tiles=None) -> torch.Tensor:
    """The same panels built where the A planes lie, with one
    ``index_add_`` (duplicate pairs add up).  With ``tiles`` (tile ids, -1
    for a pad tile) only those panels, in that order; a pad tile's panel
    is zero."""
    lm, r, ku = plan.lm, plan.r_tile, plan.ku
    tile = plan.pair_tile.astype(np.int64)
    keep = slice(None)
    ntiles = plan.ntiles
    if tiles is not None:
        tiles = np.asarray(tiles, np.int64)
        ntiles = tiles.shape[0]
        where = np.full(plan.ntiles, -1, np.int64)
        where[tiles[tiles >= 0]] = np.flatnonzero(tiles >= 0)
        tile = where[tile]
        keep = tile >= 0
        tile = tile[keep]
    base = (tile * 2 * r + plan.pair_rslot[keep]) * ku + plan.pair_kslot[keep]
    dev = a_re.device
    index = torch.from_numpy(np.concatenate([base, base + r * ku])).to(dev)
    src = torch.from_numpy(plan.pair_a[keep]).to(dev)
    flat = a_re.new_zeros((ntiles * 2 * r * ku, lm, lm))
    flat.index_add_(0, index, torch.cat([a_re[src], a_im[src]]))
    p = flat.reshape(ntiles, 2 * r, ku, lm, lm).permute(0, 1, 3, 2, 4)
    return p.reshape(ntiles, 2 * r * lm, ku * lm).contiguous()


def tile_tables(plan: PairPanelPlan, tiles, src_base: int = 0,
                span: int = 0) -> tuple:
    """K2's tables for the tiles ``tiles`` of ``plan`` (tile ids; -1 is a
    pad tile, which lists no block and writes zeros): (xloc int32[n, ku],
    kcount int32[n]), every listed X block rebased by ``src_base`` and,
    where ``span`` is given, required to lie in [0, span) blocks; a source
    outside raises ``ValueError``.  The counterpart of the JAX package's
    ``make_tile_tables`` (its ops/pairpanel.py:399-437), which rebases the
    TPU's copy codes, for the port's tables."""
    tiles = np.asarray(tiles, np.int64)
    if tiles.ndim != 1 or np.any(tiles >= plan.ntiles) or np.any(tiles < -1):
        raise ValueError(f"tile ids must lie in [-1, {plan.ntiles})")
    real = tiles >= 0
    kcount = np.where(real, plan.kcount[np.maximum(tiles, 0)], 0)
    live = np.arange(plan.ku)[None, :] < kcount[:, None]
    rel = plan.xloc[np.maximum(tiles, 0)].astype(np.int64) - int(src_base)
    bad = live & ((rel < 0) | ((rel >= span) if span else False))
    if bad.any():
        t = int(tiles[np.flatnonzero(bad.any(axis=1))[0]])
        raise ValueError(f"tile {t}: a source outside the span of {span} "
                         f"blocks from block {src_base}")
    return (np.where(live, rel, 0).astype(np.int32),
            kcount.astype(np.int32))


def permute_x(plan: PairPanelPlan, re: np.ndarray,
              im: np.ndarray) -> np.ndarray:
    """Split planes [nnzb_x, LM, LN] (old order) -> fused panel
    [n_slots*LM, 2*LN] (re in lanes [:LN], im in [LN:])."""
    out = np.concatenate([re[plan.perm], im[plan.perm]], axis=2)
    return out.reshape(plan.n_slots * plan.lm, 2 * re.shape[2])


def unpermute_y(plan: PairPanelPlan, y_fused: np.ndarray):
    """Fused [n_slots*LM, 2*LN] (new order) -> (re, im) block lists
    [nnzb_y, LM, LN] in the original order."""
    ln = y_fused.shape[1] // 2
    y = np.asarray(y_fused).reshape(-1, plan.lm, 2 * ln)[: plan.n_slots]
    re = np.zeros((plan.nnzb_y, plan.lm, ln), dtype=y.dtype)
    im = np.zeros_like(re)
    re[plan.perm] = y[:, :, :ln]
    im[plan.perm] = y[:, :, ln:]
    return re, im


# ================================================== column-grouped pairs
#
# A pair (iY, iA, iX) exists per right-hand-side column a block serves
# (tfqmrgpu.cu:183-230), so a column-sparse X streams each A block once per
# column.  Grouping G compressed columns onto the lane axis lets one A block
# serve all G: the new blocks are the occupied (row, group) cells with
# G*LN lanes, the new pair list the unique (iA, row(iY), row(iX), group),
# absent lanes of X cells are zero and Y cells are masked back to the true
# pattern.  This is exact only when the pair list is the full intersection
# of the BSR patterns, as the reference's createPlan emits it;
# ``pack_grouped`` checks that and raises ValueError otherwise.

def _optimal_groups(pmb: np.ndarray, group_size: int,
                    max_transitions: int = 2_000_000):
    """The exact minimizer, over all partitions of the columns into groups
    of ``group_size``, of the grouped pair count sum_a |{groups a's pair
    columns touch}| (A-panel blocks streamed per multiply), by DP over the
    bitmask of remaining columns.  None when ncol is not divisible by the
    group size or the instance is too big."""
    ncol = int(pmb.shape[1])
    G = int(group_size)
    if G < 2 or ncol % G != 0 or ncol > 24:
        return None
    est = 0
    rem = ncol
    while rem > 0:
        est += comb(ncol, rem) * comb(rem - 1, G - 1)
        rem -= G
    if est > max_transitions:
        return None

    # distinct A column masks with multiplicities
    col_bits = (np.int64(1) << np.arange(ncol, dtype=np.int64))
    amask = (pmb.astype(np.int64) * col_bits[None, :]).sum(axis=1)
    masks_u, counts = np.unique(amask, return_counts=True)
    combos = list(itertools.combinations(range(ncol), G))
    gmasks = np.array([sum(1 << c for c in combo) for combo in combos],
                      np.int64)
    hit = (masks_u[:, None] & gmasks[None, :]) != 0
    gcost = {int(m): int(c) for m, c in
             zip(gmasks, counts @ hit.astype(np.int64))}

    @functools.lru_cache(maxsize=None)
    def dp(remaining):
        if remaining == 0:
            return 0, ()
        b = (remaining & -remaining).bit_length() - 1
        rest = [c for c in range(ncol)
                if (remaining >> c) & 1 and c != b]
        best = None
        for combo in itertools.combinations(rest, G - 1):
            g = (1 << b) | sum(1 << c for c in combo)
            sub, sub_groups = dp(remaining & ~g)
            tot = gcost[g] + sub
            if best is None or tot < best[0]:
                best = (tot, sub_groups + (g,))
        return best

    _, chosen = dp((1 << ncol) - 1)
    dp.cache_clear()
    return [[c for c in range(ncol) if (g >> c) & 1] for g in chosen]


def _refine_groups(groups: list, pmb: np.ndarray, max_passes: int = 8):
    """Hill-climb column swaps between groups to lower the grouped pair
    count sum_a |{groups a's pair columns touch}|."""
    ncol = pmb.shape[1]
    if ncol > 128:
        return groups
    assign = np.zeros(ncol, np.int64)
    for gi, g in enumerate(groups):
        assign[np.asarray(g, dtype=np.int64)] = gi
    ngroups = len(groups)
    pm = pmb.astype(np.int16)
    # cnt[a, g]: how many of a's pair columns sit in group g
    onehot = np.zeros((ncol, ngroups), np.int16)
    onehot[np.arange(ncol), assign] = 1
    cnt = pm @ onehot
    nz = (cnt > 0).sum(axis=0).astype(np.int64)
    for _ in range(max_passes):
        improved = False
        for c1 in range(ncol):
            for c2 in range(c1 + 1, ncol):
                g1, g2 = int(assign[c1]), int(assign[c2])
                if g1 == g2:
                    continue
                m1, m2 = pm[:, c1], pm[:, c2]
                n1 = int(((cnt[:, g1] - m1 + m2) > 0).sum())
                n2 = int(((cnt[:, g2] - m2 + m1) > 0).sum())
                if n1 + n2 < nz[g1] + nz[g2]:
                    cnt[:, g1] += m2 - m1
                    cnt[:, g2] += m1 - m2
                    nz[g1], nz[g2] = n1, n2
                    assign[c1], assign[c2] = g2, g1
                    improved = True
        if not improved:
            break
    return [sorted(np.flatnonzero(assign == gi).tolist())
            for gi in range(ngroups)]


@dataclasses.dataclass
class GroupedPairs:
    """Column-grouped transform of a pair list (host, pattern only)."""

    group_size: int
    ncol: int
    ngroups: int
    nnzb2: int               # occupied (row, group) cells
    ln2: int                 # group_size * ln
    pair_a2: np.ndarray      # int64[nPairs2]  original A block ids
    pair_x2: np.ndarray      # int64[nPairs2]  cell ids
    pair_y2: np.ndarray      # int64[nPairs2]
    row_of2: np.ndarray      # int64[nnzb2]    row of each cell
    col_of2: np.ndarray      # int64[nnzb2]    group of each cell
    src_of: np.ndarray       # int64[nnzb2, group_size] block id | -1
    cell_of_blk: np.ndarray  # int64[nnzb]     cell of each block
    lane_of_blk: np.ndarray  # int64[nnzb]     lane slot of each block
    groups: list             # list[list[int]] columns of each group


def _group_columns(rbool: np.ndarray, group_size: int) -> list:
    """Greedy clustering of columns that share rows into equal groups."""
    ncol = rbool.shape[1]
    co = (rbool.astype(np.int64).T @ rbool.astype(np.int64))
    left = set(range(ncol))
    groups = []
    while left:
        seed = max(left, key=lambda c: co[c, c])
        g = [seed]
        left.discard(seed)
        while len(g) < group_size and left:
            nxt = max(left, key=lambda c: sum(int(co[c, x]) for x in g))
            g.append(nxt)
            left.discard(nxt)
        groups.append(g)
    return groups


def _choose_groups(pmb, rbool, group_size):
    groups = _optimal_groups(pmb, group_size)
    if groups is None:
        groups = _refine_groups(_group_columns(rbool, group_size), pmb)
    return groups


def pack_grouped(pair_a, pair_x, pair_y, nnzb: int, ln: int,
                 group_size: int, row_of=None, col_of=None) -> GroupedPairs:
    """Transform a full-intersection pair list into the column-grouped
    space.  Raises ValueError when the list is not a full intersection,
    holds duplicate (iY, iA, iX) triples, or has no columns to group."""
    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    row, col = _labels(pa, px, py, nnzb, row_of, col_of)
    nrow, ncol = int(row.max()) + 1, int(col.max()) + 1
    group_size = int(group_size)
    if group_size < 2 or ncol < 2:
        raise ValueError("grouping needs group_size >= 2 and >= 2 columns")

    cell_key = row * np.int64(ncol) + col
    if np.unique(cell_key).shape[0] != nnzb:
        raise ValueError("recovered (row, col) labels collide")

    trip = (pa * nnzb + py) * nnzb + px
    if np.unique(trip).shape[0] != trip.shape[0]:
        raise ValueError("duplicate (iY, iA, iX) triples cannot be grouped")

    # each used A block: its two rows and the columns its pairs serve
    au, inv = np.unique(pa, return_inverse=True)
    nau = au.shape[0]
    ai = np.zeros(nau, np.int64)
    aj = np.zeros(nau, np.int64)
    ai[inv] = row[py]
    aj[inv] = row[px]
    if (np.unique(inv * np.int64(nrow) + row[py]).shape[0] != nau
            or np.unique(inv * np.int64(nrow) + row[px]).shape[0] != nau):
        raise ValueError("an A block spans multiple recovered rows")
    pmb = np.zeros((nau, ncol), bool)
    pmb[inv, col[py]] = True
    rbool = np.zeros((nrow, ncol), bool)
    rbool[row, col] = True
    # completeness: pairs(a) must equal cols(row_i) & cols(row_j)
    if not np.array_equal(pmb, rbool[ai] & rbool[aj]):
        raise ValueError("pair list is not a full pattern intersection; "
                         "column grouping would change its semantics")

    groups = _choose_groups(pmb, rbool, group_size)
    ngroups = len(groups)
    g_of_col = np.zeros(ncol, np.int64)
    cpos_of_col = np.zeros(ncol, np.int64)
    for gi, g in enumerate(groups):
        for p, c in enumerate(g):
            g_of_col[c] = gi
            cpos_of_col[c] = p

    # occupied (row, group) cells, ordered (group, row)
    occ = np.zeros((nrow, ngroups), bool)
    occ[row, g_of_col[col]] = True
    occ_r, occ_g = np.nonzero(occ)
    o = np.lexsort((occ_r, occ_g))
    occ_r, occ_g = occ_r[o], occ_g[o]
    nnzb2 = occ_r.shape[0]
    cell2 = np.full(nrow * ngroups, -1, np.int64)
    cell2[occ_r * ngroups + occ_g] = np.arange(nnzb2)

    cell_of_blk = cell2[row * ngroups + g_of_col[col]]
    lane_of_blk = cpos_of_col[col]
    src_of = np.full((nnzb2, group_size), -1, np.int64)
    src_of[cell_of_blk, lane_of_blk] = np.arange(nnzb)

    # grouped pair list: each used A block once per group its pairs touch
    key2 = inv * np.int64(ngroups) + g_of_col[col[py]]
    uniq = np.unique(key2)
    a2 = au[uniq // ngroups]
    g2 = uniq % ngroups
    py2 = cell2[ai[uniq // ngroups] * ngroups + g2]
    px2 = cell2[aj[uniq // ngroups] * ngroups + g2]
    if np.any(py2 < 0) or np.any(px2 < 0):
        raise ValueError("internal: grouped pair hits an unoccupied cell")

    return GroupedPairs(
        group_size=group_size, ncol=ncol, ngroups=ngroups, nnzb2=nnzb2,
        ln2=group_size * ln, pair_a2=a2, pair_x2=px2, pair_y2=py2,
        row_of2=occ_r.astype(np.int64), col_of2=occ_g.astype(np.int64),
        src_of=src_of, cell_of_blk=cell_of_blk, lane_of_blk=lane_of_blk,
        groups=[list(map(int, g)) for g in groups])


def grouped_blocks(gp: GroupedPairs, blocks: np.ndarray) -> np.ndarray:
    """[nnzb, LM, LN] block data -> [nnzb2, LM, G*LN] grouped cells
    (absent lanes zero)."""
    lm, ln = blocks.shape[1], blocks.shape[2]
    src = gp.src_of.reshape(-1)
    gathered = np.where((src >= 0)[:, None, None],
                        blocks[np.maximum(src, 0)], 0).astype(blocks.dtype)
    out = gathered.reshape(gp.nnzb2, gp.group_size, lm, ln)
    return out.transpose(0, 2, 1, 3).reshape(gp.nnzb2, lm, gp.ln2)


def ungroup_blocks(gp: GroupedPairs, cells: np.ndarray) -> np.ndarray:
    """[nnzb2, LM, G*LN] grouped cells -> [nnzb, LM, LN] original blocks."""
    lm = cells.shape[1]
    ln = gp.ln2 // gp.group_size
    c4 = cells.reshape(gp.nnzb2, lm, gp.group_size, ln).transpose(0, 2, 1, 3)
    return np.asarray(c4)[gp.cell_of_blk, gp.lane_of_blk]


def grouped_lane_mask(plan: PairPanelPlan, gp: GroupedPairs) -> np.ndarray:
    """Per-slot lane mask [n_slots, 2*LN'] of the grouped layout: 1 where
    the (cell, column) is in the true pattern, 0 on absent lanes.  The same
    for all LM rows of a slot."""
    ln0 = plan.ln // gp.group_size
    m = (gp.src_of[plan.perm] >= 0).astype(np.float32)   # [n_slots, G]
    half = np.repeat(m, ln0, axis=1)
    return np.concatenate([half, half], axis=1)


def auto_group_size(pair_a, pair_x, pair_y, nnzb: int, lm: int, ln: int,
                    row_of=None, col_of=None, candidates=(1, 2, 4, 8),
                    vec_passes: float = 15.0, vec_bytes_per_val: int = 4):
    """The column group size with the least modelled iteration time.
    Returns (best G, estimates per G); 1 means no grouping.

    The model is the JAX package's full-iteration objective, 2 multiplies
    plus ``vec_passes`` passes over the G-inflated X-shaped vectors, with
    the pattern counted the same way (padded A blocks, occupied cells), at
    the card's rates (``STREAM_BYTES_PER_S``, ``FP32_FLOPS_PER_S``): a
    multiply is the larger of its A stream and its product.  Estimates
    within ``GROUP_TIE`` of the best tie, and the larger G (fewer A bytes)
    wins them.  A G whose grouping raises ``ValueError`` is skipped."""
    pa = np.asarray(pair_a, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    row, col = _labels(pa, np.asarray(pair_x, dtype=np.int64), py, nnzb,
                       row_of, col_of)
    ncol = int(col.max()) + 1
    au, inv = np.unique(pa, return_inverse=True)
    ai = np.zeros(au.shape[0], np.int64)
    ai[inv] = row[py]
    rbool = np.zeros((int(row.max()) + 1, ncol), bool)
    rbool[row, col] = True
    pmb = np.zeros((au.shape[0], ncol), bool)
    pmb[inv, col[py]] = True
    ests = {}
    for g in candidates:
        if g > ncol:
            continue
        if g == 1:
            kcnt = np.bincount(py)          # pairs per Y block
            padded = int(np.count_nonzero(kcnt) * kcnt.max())
            cells = nnzb
        else:
            try:
                groups = _choose_groups(pmb, rbool, g)
            except ValueError:
                continue    # as the JAX package: a G that cannot group
            g_of_col = np.zeros(ncol, np.int64)
            for gi, grp in enumerate(groups):
                g_of_col[grp] = gi
            ng = len(groups)
            key2 = np.unique(inv * np.int64(ng) + g_of_col[col[py]])
            tgt = ai[key2 // ng] * np.int64(ng) + key2 % ng
            kcnt = np.bincount(np.unique(tgt, return_inverse=True)[1])
            padded = int(kcnt.shape[0] * kcnt.max())
            occ = np.zeros((rbool.shape[0], ng), bool)
            occ[row, g_of_col[col]] = True
            cells = int(occ.sum())
        lanes = g * ln
        a_ms = padded * lm * lm * 8 / STREAM_BYTES_PER_S * 1e3
        op_ms = padded * lanes * lm * lm * 8 / FP32_FLOPS_PER_S * 1e3
        vec_ms = (vec_passes * cells * 2 * lm * lanes * vec_bytes_per_val
                  / STREAM_BYTES_PER_S * 1e3)
        ests[g] = dict(a_ms=a_ms, op_ms=op_ms, vec_ms=vec_ms,
                       est_ms=2 * max(a_ms, op_ms) + vec_ms, cells=cells,
                       tiles=int(kcnt.shape[0]), ku_max=int(kcnt.max()))
    if not ests:
        return 1, ests
    least = min(e["est_ms"] for e in ests.values())
    best = max(g for g, e in ests.items()
               if e["est_ms"] <= least * (1.0 + GROUP_TIE))
    return best, ests


# ==================================================================== K2

class PairPanelMultiply(metaclass=launch_counts.CountedLaunches):
    """``y = A @ x`` on fused permuted panels over a resident plan: K2.

    ``x`` is one float32 tensor [n_slots*LM, 2*LN'] (re lanes, then im
    lanes); the result has the same shape.  For every tile t the kernel
    multiplies the fused A panel [2*r*LM, ku*LM] with the tile's union X
    rows (``xloc``) and writes [P1 - Q2 | P2 + Q1] (P the re rows of the
    product, Q the im rows, 1 and 2 the re and im lanes) for the tile's
    rows below n_slots*LM.

    The port runs this kernel for every packed plan, narrow lanes
    included: the JAX package's step-pipelined kernel and its ``t_step``
    exist to amortise the TPU's per-grid-step cost within its VMEM budget,
    which the card does not have.  On a CUDA tensor the wrapper launches
    ``csrc/pairpanel_tiles.cu`` or raises; on a CPU tensor it runs
    ``plain``.  The kernel runs the unit tables and the work list of
    ``ops/paneltiles.py`` (tiles narrower than a CTA side by side, each X
    block of their union staged once).  On the card the panels are kept
    once, depth-major ([ntiles, ku*LM, 2*rlm], the layout the kernel stages
    from); ``a_panels`` is then a transposed view of them.  ``slots``
    overrides the CTAs the work list is dealt to (by default what the card
    holds at once); the result does not depend on it.  ``launches`` reads
    the kernel's launch counter on the card (``launch_counts``); the plain
    version never adds to it.

    A sharded solve multiplies a part of the plan: ``tiles`` lists its
    tiles (-1 for a pad tile), ``a_panels`` holds their panels in that
    order, and the X blocks they list are rebased by ``src_base`` and
    checked against ``span`` blocks (``tile_tables``).  X then has rows of
    its own, ``span*LM`` (``x_rows``), and the call writes all
    ``len(tiles)*r_tile*LM`` rows of the tiles.  ``out`` and
    ``row0`` put those rows into a Y the caller gives, from row ``row0``
    on, so that the parts of one multiply fill one Y.

    ``precision`` is one of ``PRECISIONS``.  'highest' runs the exact FP32
    kernel above; a split mode ('bf16', 'bf16x3', 'bf16x4', 'bf16x6') runs
    the X split pass (``paneltiles.XSplit``) and then
    ``csrc/pairpanel_tiles_bf16.cu`` on the BF16 tensor cores, over A split
    once into staged bf16 slabs (``paneltiles.SplitOperands``) and the
    union tables of its own CTA shape (``paneltiles.mma_shape``), and its
    plain version is ``split_product`` in the order of the kernel's
    products.  A split
    mode needs LM >= 16, as the JAX kernel's bf16 windows do, and raises
    ValueError below.  ``split_launches`` reads that kernel's counter.
    """

    _counters = {"launches": "k2", "split_launches": "k2_split"}

    def __init__(self, plan: PairPanelPlan, a_panels: torch.Tensor,
                 slots: int = None, *, tiles=None, src_base: int = 0,
                 span: int = 0, precision: str = "highest"):
        self.precision = self.mode = check_precision(precision)
        self.split = precision != "highest"
        if self.split and plan.lm < 16:
            raise ValueError(f"precision {precision!r} needs a kernel LM >= "
                             f"16 (the JAX kernel's bf16 windows), got "
                             f"{plan.lm}")
        self.ku, self.lm = plan.ku, plan.lm
        self.ln = plan.ln
        self.rlm = plan.r_tile * plan.lm
        if tiles is None:
            xloc, kcount = plan.xloc, plan.kcount
            self.ntiles = plan.ntiles
            self.n_rows = plan.n_slots * plan.lm
            self.x_rows = self.n_rows
        else:
            xloc, kcount = tile_tables(plan, tiles, src_base, span)
            self.ntiles = int(xloc.shape[0])
            self.n_rows = self.ntiles * self.rlm
            self.x_rows = span * plan.lm if span else plan.n_slots * plan.lm
        if np.any(xloc.astype(np.int64) * self.lm >= self.x_rows):
            raise ValueError(f"a tile lists an X block past the {self.x_rows} "
                             "rows of X")
        dev = a_panels.device
        if a_panels.dtype != torch.float32:
            raise TfqmrgpuError(encode_status(Status.PRECISION_MISSMATCH),
                                "the packed pairs engine is float32-only, "
                                f"got {a_panels.dtype}")
        shape = (self.ntiles, 2 * self.rlm, self.ku * self.lm)
        if tuple(a_panels.shape) != shape or not a_panels.is_contiguous():
            raise ValueError(f"A panels must be a contiguous {shape} tensor, "
                             f"got {tuple(a_panels.shape)}")
        if dev.type == "cuda" and self.lm % 4:
            raise TfqmrgpuError(encode_status(Status.BLOCKSIZE_MISSING),
                                "the packed pairs kernel takes LM in "
                                f"multiples of 4, got {self.lm}")
        shape = paneltiles.mma_shape(self.ln) if self.split else None
        self.units = (paneltiles.unit_tables(xloc, kcount, self.rlm, shape[0],
                                             union=True) if self.split else
                      paneltiles.unit_tables_for(xloc, kcount, self.rlm,
                                                 self.ln))
        if dev.type == "cuda":
            self.a_dm = paneltiles.depth_major(a_panels)
            self.a_panels = self.a_dm.transpose(1, 2)
            if self.split:
                self.split_ops = paneltiles.SplitOperands(
                    self.units, self.a_panels, precision, self.lm, self.ln,
                    self.x_rows, shape[1])
            self.launch_tables = paneltiles.PanelLaunch(
                self.units, self.lm, self.ln, dev, slots, shape=shape)
        else:
            self.a_panels = a_panels
        self.xloc = torch.from_numpy(
            np.ascontiguousarray(xloc, dtype=np.int32)).to(dev)

    @property
    def device(self) -> torch.device:
        return self.a_panels.device

    def _check(self, x: torch.Tensor, rows: int = None, what: str = "x"):
        shape = (self.x_rows if rows is None else rows, 2 * self.ln)
        if (x.device != self.device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{what} must be a contiguous {shape} float32 tensor on "
                f"{self.device}; got {tuple(x.shape)} {x.dtype} on {x.device}")

    def _rows_of(self, out: Optional[torch.Tensor], row0: int) -> torch.Tensor:
        """The rows this call writes: ``out[row0:row0 + n_rows]``, or a new
        tensor."""
        if out is None:
            if row0:
                raise ValueError("row0 needs out")
            return torch.empty((self.n_rows, 2 * self.ln), dtype=torch.float32,
                               device=self.device)
        row0 = int(row0)
        if not 0 <= row0 <= out.shape[0] - self.n_rows:
            raise ValueError(f"rows {row0}:{row0 + self.n_rows} lie outside "
                             f"the {out.shape[0]} rows of out")
        self._check(out, out.shape[0], "out")
        return out[row0:row0 + self.n_rows]

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version, on any device: gather the tiles'
        union rows by ``xloc``, one ``torch.bmm`` (or the split mode's
        products), combine the halves."""
        nt, rlm, c = self.ntiles, self.rlm, self.ln
        xs = x.reshape(-1, self.lm, 2 * c)[self.xloc.to(torch.int64)]
        xs = xs.reshape(nt, self.ku * self.lm, 2 * c)
        d = (split_product(self.a_panels, xs, self.precision)
             if self.split else torch.bmm(self.a_panels, xs))
        p, q = d[:, :rlm], d[:, rlm:]
        y = torch.cat([p[..., :c] - q[..., c:], p[..., c:] + q[..., :c]], 2)
        return y.reshape(nt * rlm, 2 * c)[: self.n_rows].contiguous()

    def __call__(self, x: torch.Tensor, out: torch.Tensor = None,
                 row0: int = 0) -> torch.Tensor:
        """The product's rows; with ``out``, written into its rows from
        ``row0`` on (and that view returned)."""
        self._check(x)
        y = self._rows_of(out, row0)
        if self.device.type == "cpu":
            y.copy_(self.plain(x))
            return y
        if self.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no packed pairs kernel for {self.device}")
        return self._launch(x, y)

    def _launch(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        from .._build import load_kernels

        return self.launch_with(load_kernels(), x, y)

    def launch_with(self, lib, x: torch.Tensor,
                    y: torch.Tensor = None) -> torch.Tensor:
        """Launch through the kernel library ``lib``: the built one, or
        another build of the sources (``tools/kernel_compare.py``), into
        ``y`` (the ``n_rows`` rows it writes; a new tensor by default)."""
        if y is None:
            y = self._rows_of(None, 0)
        lt = self.launch_tables
        dims = (self.ntiles, self.rlm, self.ku, self.lm, self.ln, self.n_rows,
                self.units.nt, self.units.ksteps, lt.bm, lt.bn)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            if self.split:
                ops, mode = self.split_ops, SPLIT_PRODUCTS[self.precision]
                tables, nctas = lt.args(
                    lambda *shape: lib.tfq_pairpanel_tiles_bf16_slots(
                        *shape, mode))
                uslot, _, ucount, items, cta_start = tables
                ops.xsplit(x[:, :self.ln], x[:, self.ln:], lib)
                rc = lib.tfq_pairpanel_tiles_bf16(
                    ops.maps(lib), y.data_ptr(), uslot, ucount,
                    ops.abase.data_ptr(), items, cta_start, nctas,
                    self.ntiles, self.rlm, self.lm, self.ln, self.n_rows,
                    self.units.nt, self.units.ksteps, lt.bm, lt.bn, ops.kc,
                    mode, stream,
                    launch_counts.pointer(self.device, "k2_split"))
            else:
                tables, nctas = lt.args(lib.tfq_pairpanel_tiles_slots)
                rc = lib.tfq_pairpanel_tiles_f32(
                    self.a_dm.data_ptr(), x.data_ptr(), y.data_ptr(),
                    *tables, nctas, *dims, stream,
                    launch_counts.pointer(self.device, "k2"))
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"packed pairs kernel ({self.precision}) "
                                f"returned {rc}")
        return y


# ========================================================== K1's Ozaki modes
#
# The JAX package runs every 'z' solve of its 'pairs' engine through the
# Ozaki branches of K1's TPU body (its pairpanel.py:1527-1647): A and X are
# cut into p exponent-blocked slices (int8 or bf16), the kernel takes the
# slice products s + t <= p - 1 on the matrix unit, each exact, reduces
# them in a fixed order, and a float64 combine outside restores the
# product.  The port runs 'z' natively on K1's FP64 tensor cores; this
# route is the opt-in TFQ_PAIRS_Z_OZ=1 (solver.py), on the hand-written
# kernel ``csrc/pairpanel_oz.cu``, in the JAX package's three bodies:
#
#   'ozc'  A bf16 (q 8) or int8 raw ints (TFQ_OZC_INT8=1, q 7) re-scaled to
#          bf16, X bf16: every product exact in float32, folded in diagonal
#          order (TwoSum up to diagonal 4, a plain tail beyond), then the
#          complex assembly as two more TwoSum steps: [M, 4LN] of
#          (re_acc | im_acc | re_err | im_err);
#   'xi8'  A and X int8 raw ints (TFQ_OZC_INT8=2/3 at LM % 32 == 0), int32
#          diagonal sums, each split into a multiple of 2^12 and a
#          remainder and TwoSum-folded, then the same assembly;
#   'oz'   (TFQ_OZ_COMP=0) A int8 (TFQ_OZ_INT8=1) or bf16, X bf16: the raw
#          per-diagonal float32 sums [2M, p*2LN], exact by slice_params'
#          diag_sum bound, summed in float64 outside.

OZ_BODIES = ("oz", "ozc", "xi8")


def z_oz_enabled() -> bool:
    """Whether TFQ_PAIRS_Z_OZ (default '0') sends 'z' on the 'pairs' engine
    to the JAX package's packed route on the oz kernel."""
    return os.environ.get("TFQ_PAIRS_Z_OZ", "0") != "0"

# the slice counts the card's kernel is built for, by body
OZ_KERNEL_P = {"oz": (7, 8, 9, 11, 14), "ozc": (7, 8, 9), "xi8": (8, 9)}
# 'ozc' TwoSum-folds the products of diagonals d <= this; deeper ones
# accumulate plainly into a tail (the JAX body's hybrid fold)
OZ_TWOSUM_DIAGONALS = 4
# the oz kernel's blocks of rows of P and of Q (csrc/pairpanel_oz.cu HROWS)
OZ_HALF_ROWS = 32


def oz_mode_params(k: int, bits: int = 53,
                   int8: str = None) -> tuple[str, int, int]:
    """(precision tag, p, q) of the multiply ``make_pairpanel_multiply_oz``
    builds for contraction depth ``k`` under TFQ_OZ_COMP, TFQ_OZC_INT8
    (or ``int8``) and TFQ_OZ_INT8, the JAX package's function and errors:
    'ozc' (the default) with bf16 A at q 8 / p 7, int8 raw-int A at q 7 /
    p 8 for a TFQ_OZC_INT8 other than '0', and at '2' / '3' the 'xi8'
    depth bound p*k*66^2 <= 2^31; TFQ_OZ_COMP=0 the legacy 'oz' at
    ``slice_params(diag_sum=True)``, re-sliced at q 7 for int8 A."""
    if os.environ.get("TFQ_OZC_INT8") is not None and int8 is None:
        int8 = os.environ.get("TFQ_OZC_INT8")
    if os.environ.get("TFQ_OZ_COMP", "1") != "0":
        p, q = ozaki.slice_params_comp(k, bits)
        i8 = int8 if int8 is not None else "0"
        if i8 != "0" and q > 7:
            # int8 ints <= 2^{q-1} + 2 <= 66 at q 7
            q = 7
            p = math.ceil(bits / q) + (1 if bits % q == 0 else 0)
        if i8 in ("2", "3"):
            if p * k * (2 ** (q - 1) + 2) ** 2 > 2 ** 31:
                raise ValueError(f"contraction depth {k} too deep for "
                                 f"int32 slice accumulation at q={q}")
        elif k * (2 ** (q - 1) + 2) ** 2 > 2 ** 24:
            raise ValueError(f"contraction depth {k} too deep for exact "
                             f"f32 slice products at q={q}")
        return f"ozc{p}", p, q
    p, q = ozaki.slice_params(k, bits, diag_sum=True)
    if os.environ.get("TFQ_OZ_INT8", "1") != "0" and q > 7:
        q = 7
        p = max(p, -(-54 // 7))
    return f"oz{p}", p, q


def _oz_slices(pure: torch.Tensor, p: int, q: int) -> list:
    """p bf16 slices of a float64 tensor descaled to |.| <= 1: pure ==
    sum_s slices[s] + O(2^{-pq}); slice s is an integer times 2^{-(s+1)q},
    and the residual subtracts the stored slice (JAX: ``_oz_slices``)."""
    r = pure
    out = []
    for s in range(p):
        step = 2.0 ** ((s + 1) * q)
        sl = (torch.round(r * step) / step).to(torch.bfloat16)
        r = r - sl.to(torch.float64)
        out.append(sl)
    return out


def _oz_slices_f32pair(hi: torch.Tensor, lo: torch.Tensor, p: int, q: int,
                       out_int8: bool = False) -> list:
    """p slices of the exact float32 pair (hi, lo), |hi + lo| <= 0.5, in
    float32 arithmetic only (JAX: ``_oz_slices_f32pair``): each stream is
    sliced on the shared grid, the two merged, and a downward carry sweep
    keeps every slice int within 2^{q-1} + 2.  bf16 slice values, or with
    ``out_int8`` the raw slice integers as int8 (the 'xi8' X side)."""
    rh, rl = hi, lo
    ms = []
    for s in range(p):
        step = 2.0 ** ((s + 1) * q)
        istep = 2.0 ** (-(s + 1) * q)
        sh = torch.round(rh * step) * istep
        rh = rh - sh
        if (s + 1) * q <= 24:
            # |lo| <= 2^-25: its rounds at these grids are exactly zero
            ms.append(sh)
            continue
        sl = torch.round(rl * step) * istep
        rl = rl - sl
        ms.append(sh + sl)
    for s in range(p - 1, 0, -1):
        c = torch.round(ms[s] * 2.0 ** (s * q)) * 2.0 ** (-s * q)
        ms[s - 1] = ms[s - 1] + c
        ms[s] = ms[s] - c
    if out_int8:
        return [(m * 2.0 ** ((s + 1) * q)).to(torch.int8)
                for s, m in enumerate(ms)]
    return [m.to(torch.bfloat16) for m in ms]


def _oz_slices_int8(pure: torch.Tensor, p: int, q: int,
                    r_cap_log2: int = 0) -> list:
    """p raw-integer int8 slices of a float64 tensor descaled to
    |.| <= 2^{r_cap_log2}: pure == sum_s slices[s] * 2^{-(s+1)q} +
    O(2^{-pq}), with the carry sweep that keeps every int within
    2^{q-1} + 2 (JAX: ``_oz_slices_int8``, the same ValueError where an
    int could overflow int8)."""
    if q - 1 > 7 or q + r_cap_log2 > 7:
        raise ValueError(f"q={q} (first-slice cap 2^{q + r_cap_log2}, "
                         f"residual cap 2^{q - 1}) overflows int8")
    r = pure
    ints = []
    for s in range(p):
        step = 2.0 ** ((s + 1) * q)
        sl = torch.round(r * step).to(torch.float32)
        r = r - sl.to(torch.float64) / step
        ints.append(sl)
    for s in range(p - 1, 0, -1):
        c = torch.round(ints[s] * 2.0 ** -q)
        ints[s - 1] = ints[s - 1] + c
        ints[s] = ints[s] - c * 2.0 ** q
    return [i.to(torch.int8) for i in ints]


def oz_kernel_planes(planes: torch.Tensor, p: int, q: int, m: int,
                     rescale: bool, stage_bytes: int) -> torch.Tensor:
    """The oz kernel's A operand, built once a solve from the A slices
    ``planes`` [nt, p*2m, K] (int8 or bf16): int8 slices re-scaled into
    bf16 values where ``rescale`` (slice s times 2^-(s+1)q, exact: at most
    7 significant bits), laid out as the kernel stages them,
    [nt, row blocks, K/depth, p, P|Q, 32 rows, chunks, 16 bytes] (a stage
    ``stage_bytes`` deep, 2 or 4 chunks of 16 bytes; rows past m zero),
    with the swizzle of its shared memory applied: chunk c of row r lies
    at c ^ (r * stage_bytes / 128 mod chunks)."""
    nt, _, k = planes.shape
    v = planes
    if rescale:
        scale = torch.tensor([2.0 ** (-(s + 1) * q) for s in range(p)],
                             dtype=torch.float32, device=planes.device)
        v = (planes.view(nt, p, -1).to(torch.float32)
             * scale[None, :, None]).to(torch.bfloat16)
    esz = v.element_size()
    kc, chunks, hr = stage_bytes // esz, stage_bytes // 16, OZ_HALF_ROWS
    nrb = -(-m // hr)
    v = v.reshape(nt, p, 2, m, k)
    if nrb * hr != m:
        v = torch.cat([v, v.new_zeros((nt, p, 2, nrb * hr - m, k))], dim=3)
    v = v.reshape(nt, p, 2, nrb, hr, k // kc, chunks, 16 // esz)
    v = v.permute(0, 3, 5, 1, 2, 4, 6, 7)
    rows = torch.arange(hr, device=v.device)
    src = (torch.arange(chunks, device=v.device)[None, :]
           ^ ((rows[:, None] * stage_bytes // 128) % chunks))
    # the chunk stored at position c of row r is chunk c ^ x(r) of the data
    v = torch.gather(v, 6, src[:, :, None].expand(hr, chunks, 16 // esz)
                     .expand(*v.shape[:5], hr, chunks, 16 // esz))
    return v.contiguous()


def _two_sum(acc: torch.Tensor, err: torch.Tensor, b: torch.Tensor):
    """One step of the Knuth TwoSum chain in float32: (acc + b rounded,
    err plus the exact rounding error), in the JAX body's order."""
    tot = acc + b
    a_v = tot - b
    b_v = tot - a_v
    return tot, err + ((acc - a_v) + (b - b_v))


def oz_finish(acc: torch.Tensor, err: torch.Tensor, m: int,
              c: int) -> torch.Tensor:
    """The in-kernel complex assembly of 'ozc' / 'xi8' (JAX: ``finish``):
    acc, err [nt, 2m, 2c] float32 (P rows over Q rows, re lanes then im
    lanes) -> [nt, m, 4c] = (re_acc | im_acc | re_err | im_err), re = P1 -
    Q2 and im = P2 + Q1 each as one TwoSum step."""
    pa, qa = acc[:, :m], acc[:, m:]
    pe, qe = err[:, :m], err[:, m:]
    a1, b1 = pa[..., :c], -qa[..., c:]
    t1 = a1 + b1
    av = t1 - b1
    bv = t1 - av
    e1 = ((a1 - av) + (b1 - bv)) + (pe[..., :c] - qe[..., c:])
    a2, b2 = pa[..., c:], qa[..., :c]
    t2 = a2 + b2
    av2 = t2 - b2
    bv2 = t2 - av2
    e2 = ((a2 - av2) + (b2 - bv2)) + (pe[..., c:] + qe[..., :c])
    return torch.cat([t1, t2, e1, e2], dim=2)


def oz_body_plain(a_cat: torch.Tensor, xw: torch.Tensor, xloc: torch.Tensor,
                  m: int, lm: int, c: int, p: int, q: int, body: str,
                  a_int8: bool, slot_rows: int = 0) -> torch.Tensor:
    """The plain version of the oz kernel, on any device: tile t's A slices
    a_cat[t] [p*2m, K] (int8 or bf16) times the X slice rows of its union
    (``xloc``; xw [slots*slot_rows, p*2c] in any layout, bf16 or int8, a
    slot ``slot_rows`` rows, lm by default, of which the first lm hold the
    slot's X), reduced as ``body`` does.

    Every slice product is taken in float64 with ``torch.matmul``, where it
    is exact, and cast to float32 (exact: the slice bounds keep each
    product within 2^24 of its grid), or for 'xi8' to int64.  int8 A of
    the bf16 bodies is re-scaled by 2^{-(s+1)q}, as the kernel does.  The
    reductions then run in the JAX body's order: 'oz' the float32 diagonal
    sums [nt, 2m, p*2c]; 'ozc' the hybrid TwoSum fold; 'xi8' the int64
    diagonal sums split at 2^12 and folded; both through ``oz_finish``
    into [nt, m, 4c]."""
    f32, f64 = torch.float32, torch.float64
    nt, rows_a, k = a_cat.shape
    m2, two = 2 * m, 2 * c
    if rows_a != p * m2:
        raise ValueError(f"A slices of {rows_a} rows for p={p}, 2M={m2}")
    xs = xw.reshape(-1, slot_rows or lm, p * two)[xloc.to(torch.int64)]
    xs = xs[:, :, :lm].reshape(nt, k, p * two).to(f64)
    a = a_cat.to(f64)
    if a_int8 and body != "xi8":
        scale = torch.tensor([2.0 ** (-(s + 1) * q) for s in range(p)],
                             dtype=f64, device=a.device)
        a = (a.view(nt, p, m2, k) * scale[None, :, None, None]).view(
            nt, p * m2, k)
    # dot s: A slice s times the X slices t <= p-1-s, side by side
    dots = [torch.matmul(a[:, s * m2:(s + 1) * m2],
                         xs[..., :(p - s) * two]) for s in range(p)]

    def prod(s, t):
        return dots[s][..., t * two:(t + 1) * two]

    if body == "xi8":
        acc = err = None
        for d in range(p):
            tot = sum(prod(s, d - s).to(torch.int64) for s in range(d + 1))
            sc = 2.0 ** (-(d + 2) * q)
            lo_i = torch.fmod(tot, 4096)
            hi_i = tot - lo_i
            for v in (hi_i.to(f32) * sc, lo_i.to(f32) * sc):
                if acc is None:
                    acc, err = v, torch.zeros_like(v)
                else:
                    acc, err = _two_sum(acc, err, v)
        return oz_finish(acc, err, m, c)
    if body == "ozc":
        acc = prod(0, 0).to(f32)
        err = torch.zeros_like(acc)
        tail = torch.zeros_like(acc)
        for d in range(1, p):
            for s in range(d + 1):
                b = prod(s, d - s).to(f32)
                if d <= OZ_TWOSUM_DIAGONALS:
                    acc, err = _two_sum(acc, err, b)
                else:
                    tail = tail + b
        return oz_finish(acc, err + tail, m, c)
    cols = []
    for d in range(p):
        acc = prod(0, d).to(f32)
        for s in range(1, d + 1):
            acc = acc + prod(s, d - s).to(f32)
        cols.append(acc)
    return torch.cat(cols, dim=2)


class OzPairPanelMultiply(metaclass=launch_counts.CountedLaunches):
    """float64-quality ``y = A @ x`` on fused permuted panels from exact
    slice products: the JAX package's 'z' multiply of its 'pairs' engine
    (``OzPairPanelMultiply``), on the oz kernel ``csrc/pairpanel_oz.cu``.

    ``x`` is a float64 fused panel [n_slots*LM, 2*LN'] (re lanes, then im
    lanes); the result has the same shape.  ``slice_x`` takes X's
    power-of-two lane scale tau (shared across the re/im lanes in 'ozc' and
    'xi8', doubled for the spare binade) and its p slice planes
    [n_slots*klm, p*2LN'] (bf16, or int8 for 'xi8'), stored lane-major, as
    the kernel reads them: a slot is ``klm`` rows, LM rounded up to 16 (the
    kernel's stage depth), the rows past LM zero; ``body`` runs the kernel
    on them (on a CUDA tensor the kernel or a raise; on a CPU tensor
    ``body_plain``), and ``combine`` descales in float64: f64(acc) +
    f64(err) times sigma*tau in 'ozc' / 'xi8', the diagonal sums then the
    complex assembly in 'oz'.  The JAX package takes float32 fast paths of
    the prologue and the combine under ``lax.cond`` where they are exact;
    the card has float64, so the port always takes the float64 branch,
    which gives the same bits wherever the fast branch is valid.

    ``launches`` reads the kernel's launch counter on the card
    (``launch_counts``); the plain version never adds to it.  ``mode`` is the
    precision tag ('ozcN' or 'ozN'), ``body`` one of ``OZ_BODIES``.
    ``planes`` are the JAX package's A slices, which the plain version
    reads; the kernel reads ``kernel_planes``, the same slices staged once
    by ``oz_kernel_planes`` (int8 ones of the bf16 bodies re-scaled into
    the bf16 values they stand for), on the card."""

    _counters = {"launches": "oz"}

    def __init__(self, plan: PairPanelPlan, planes: torch.Tensor,
                 sigma: torch.Tensor, p: int, q: int, comp: bool,
                 xi8: bool, a_int8: bool):
        self.p, self.q = int(p), int(q)
        self.comp, self.xi8, self.a_int8 = bool(comp), bool(xi8), bool(a_int8)
        self.body = "xi8" if xi8 else "ozc" if comp else "oz"
        self.mode = f"ozc{p}" if comp else f"oz{p}"
        self.lm, self.ln, self.ku = plan.lm, plan.ln, plan.ku
        self.m = plan.r_tile * plan.lm
        self.ntiles = plan.ntiles
        self.n_rows = plan.n_slots * plan.lm
        shape = (self.ntiles, self.p * 2 * self.m, self.ku * self.lm)
        if tuple(planes.shape) != shape or not planes.is_contiguous():
            raise ValueError(f"A slices must be a contiguous {shape} tensor, "
                             f"got {tuple(planes.shape)}")
        want = torch.int8 if self.a_int8 else torch.bfloat16
        if planes.dtype != want:
            raise ValueError(f"A slices of {planes.dtype}, expected {want}")
        dev = planes.device
        if dev.type == "cuda":
            if self.p not in OZ_KERNEL_P[self.body]:
                raise ValueError(f"the oz kernel's '{self.body}' body is built "
                                 f"for p in {OZ_KERNEL_P[self.body]}, not "
                                 f"{self.p}")
            if self.lm % 4:
                raise TfqmrgpuError(encode_status(Status.BLOCKSIZE_MISSING),
                                    "the oz kernel takes LM in multiples of "
                                    f"4, got {self.lm}")
        self.planes, self.sigma = planes, sigma
        # the kernel's slots: a stage (16 bf16 or 32 int8 entries of depth)
        # lies in one, so slots of LM 4 and 8 take zero rows to 16, in the
        # staged A once and in the X slice planes as slice_x makes them
        # ('xi8' runs at LM multiples of 32 only)
        self.klm = -(-self.lm // 16) * 16
        self.x_rows = plan.n_slots * self.klm
        self.kernel_planes = None
        if dev.type == "cuda":
            from .._build import load_kernels

            kp = planes
            if self.klm != self.lm:
                kp = planes.new_zeros(shape[:2] + (self.ku, self.klm))
                kp[..., :self.lm] = planes.view(shape[:2] + (self.ku,
                                                             self.lm))
                kp = kp.view(shape[:2] + (self.ku * self.klm,))
            self.kernel_planes = oz_kernel_planes(
                kp, self.p, self.q, self.m, self.a_int8 and not self.xi8,
                load_kernels().tfq_pairpanel_oz_stage_bytes(
                    OZ_BODIES.index(self.body), self.p, self.klm))
        self.xloc = torch.from_numpy(
            np.ascontiguousarray(plan.xloc, dtype=np.int32)).to(dev)
        self.kcount = torch.from_numpy(
            np.ascontiguousarray(plan.kcount, dtype=np.int32)).to(dev)

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @property
    def raw_shape(self) -> tuple:
        """The kernel's output: [ntiles, M, 4LN'] or, in 'oz', [ntiles, 2M,
        p*2LN']."""
        if self.body == "oz":
            return (self.ntiles, 2 * self.m, self.p * 2 * self.ln)
        return (self.ntiles, self.m, 4 * self.ln)

    def slice_x(self, x: torch.Tensor) -> tuple:
        """(X slice planes [n_slots*klm, p*2LN'], tau [1, 2LN'] float64).
        The planes are stored lane-major (their transpose [p*2LN',
        n_slots*klm] is contiguous, the layout the kernel's tensor map
        reads), each slot padded with zero rows to klm: the slicer runs
        elementwise on x transposed, and the copy that joins the slices
        writes them into their padded slots, so no pass transposes or pads
        them."""
        c, p, q, lm = self.ln, self.p, self.q, self.lm
        xt = x.t().contiguous()                         # [2LN', rows]
        amax = xt.abs().amax(dim=1, keepdim=True)
        if self.comp:
            half = torch.maximum(amax[:c], amax[c:])
            tau = ozaki.pow2_scale(torch.cat([half, half], dim=0)) * 2.0
            r = xt / tau                                # exact: powers of two
            hi = r.to(torch.float32)
            lo = (r - hi.to(torch.float64)).to(torch.float32)
            xs = _oz_slices_f32pair(hi, lo, p, q, out_int8=self.xi8)
        else:
            tau = ozaki.pow2_scale(amax)
            xs = _oz_slices(xt / tau, p, q)
        if self.klm == lm:
            return torch.cat(xs, dim=0).t(), tau.t()
        out = xs[0].new_zeros((p, 2 * c, self.x_rows // self.klm, self.klm))
        for s, v in enumerate(xs):
            out[s, ..., :lm] = v.view(2 * c, -1, lm)
        return out.view(p * 2 * c, self.x_rows).t(), tau.t()

    def body_plain(self, xw: torch.Tensor) -> torch.Tensor:
        """The kernel's output by the plain version, on any device."""
        return oz_body_plain(self.planes, xw, self.xloc, self.m, self.lm,
                             self.ln, self.p, self.q, self.body, self.a_int8,
                             self.klm)

    def body_out(self, xw: torch.Tensor) -> torch.Tensor:
        """The kernel's output: the kernel on a CUDA tensor, the plain
        version on a CPU one."""
        want = torch.int8 if self.xi8 else torch.bfloat16
        shape = (self.x_rows, self.p * 2 * self.ln)
        if (xw.device != self.device or xw.dtype != want
                or tuple(xw.shape) != shape or not xw.t().is_contiguous()):
            raise ValueError(f"X slices must be a {shape} {want} tensor "
                             f"stored lane-major (as slice_x gives them) on "
                             f"{self.device}; got {tuple(xw.shape)} "
                             f"{xw.dtype} on {xw.device}")
        if self.device.type == "cpu":
            return self.body_plain(xw)
        if self.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no oz kernel for {self.device}")
        return self._launch(xw)

    def _launch(self, xw: torch.Tensor) -> torch.Tensor:
        from .._build import load_kernels

        lib = load_kernels()
        y = torch.empty(self.raw_shape, dtype=torch.float32,
                        device=self.device)
        xk = xw.t()                    # [p*2LN', n_slots*klm], contiguous
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = lib.tfq_pairpanel_oz(
                self.kernel_planes.data_ptr(), xk.data_ptr(), y.data_ptr(),
                self.xloc.data_ptr(), self.kcount.data_ptr(), self.ntiles,
                self.m, self.ku, self.klm, self.ln, self.x_rows,
                self.p, self.q, OZ_BODIES.index(self.body), int(self.a_int8),
                stream, launch_counts.pointer(self.device, "oz"))
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"oz kernel ({self.body}) returned {rc}")
        return y

    def combine(self, raw: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        """The float64 combine of the kernel's output: the fused product
        [n_slots*LM, 2LN']."""
        c, m = self.ln, self.m
        f64 = torch.float64
        if self.body != "oz":
            fused = ((raw[..., :2 * c].to(f64) + raw[..., 2 * c:].to(f64))
                     * self.sigma * tau[None])
        else:
            y = sum(raw[..., 2 * c * d:2 * c * (d + 1)].to(f64)
                    for d in range(self.p))
            y = y * self.sigma * tau[None]
            pt, qt = y[:, :m], y[:, m:]
            fused = torch.cat([pt[..., :c] - qt[..., c:],
                               pt[..., c:] + qt[..., :c]], dim=2)
        return fused.reshape(-1, 2 * c)[:self.n_rows].contiguous()

    def _check(self, x: torch.Tensor):
        shape = (self.n_rows, 2 * self.ln)
        if (x.device != self.device or x.dtype != torch.float64
                or tuple(x.shape) != shape):
            raise ValueError(f"x must be a {shape} float64 tensor on "
                             f"{self.device}; got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The whole multiply with the plain kernel body, on any device."""
        self._check(x)
        xw, tau = self.slice_x(x)
        return self.combine(self.body_plain(xw), tau)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        xw, tau = self.slice_x(x)
        return self.combine(self.body_out(xw), tau)


def make_pairpanel_multiply_oz(plan: PairPanelPlan, a_re: torch.Tensor,
                               a_im: torch.Tensor, t_step: int = 1,
                               bits: int = 53,
                               int8: str = None) -> OzPairPanelMultiply:
    """Build the float64-quality ('z') multiply of the packed plan from
    float64 A blocks [nnzb, LM, LM] on their device (JAX:
    ``make_pairpanel_multiply_oz``): the fused panels in float64, their
    per-row power-of-two scale sigma (in 'ozc' shared across the re/im
    halves and doubled, the dual spare binade), p slice planes (int8 raw
    ints or bf16 values) concatenated as [ntiles, p*2M, K].  The mode is
    ``oz_mode_params(ku*LM, bits, int8)``'s; a 'xi8' request falls back to
    the mixed int8-A / bf16-X body where LM % 32 != 0, and raises
    ValueError where that body's float32 bound fails, as JAX does.

    Only the resident layout exists here, so the JAX refusal of resident
    plans outside 'xi8' (a VMEM limit) does not apply; ``t_step`` changes
    nothing that is computed and is accepted and ignored, as K2 does."""
    del t_step
    r, lm = plan.r_tile, plan.lm
    k = plan.ku * lm
    tag, p, q = oz_mode_params(k, bits, int8=int8)
    comp = tag.startswith("ozc")
    if comp:
        i8_env = (int8 if int8 is not None else
                  os.environ.get("TFQ_OZC_INT8", "0"))
    else:
        i8_env = os.environ.get("TFQ_OZ_INT8", "1")
    use_int8 = i8_env != "0"
    xi8 = comp and i8_env in ("2", "3") and q <= 7 and lm % 32 == 0
    if comp and use_int8 and not xi8 \
            and k * (2 ** (q - 1) + 2) ** 2 > 2 ** 24:
        raise ValueError(f"contraction depth {k} too deep for exact f32 "
                         f"slice products at q={q} (xi8 unavailable at "
                         f"lm={lm})")
    f64 = torch.float64
    panels = build_a_panels_device(plan, a_re.to(f64), a_im.to(f64))
    sigma = ozaki.pow2_scale(panels.abs().amax(dim=2, keepdim=True))
    a_int8 = use_int8 and q <= 7        # (always q <= 7 in legacy 'oz')
    if comp:
        mr = r * lm
        sig_sh = torch.maximum(sigma[:, :mr], sigma[:, mr:])
        sigma = torch.cat([sig_sh, sig_sh], dim=1) * 2.0
        planes = (_oz_slices_int8(panels / sigma, p, q, r_cap_log2=-1)
                  if a_int8 else _oz_slices(panels / sigma, p, q))
        sigma = sigma[:, :mr].contiguous()
    elif a_int8:
        if 2 ** q > 64:
            sigma = sigma * 2.0
        planes = _oz_slices_int8(panels / sigma, p, q)
    else:
        planes = _oz_slices(panels / sigma, p, q)
    return OzPairPanelMultiply(plan, torch.cat(planes, dim=1).contiguous(),
                               sigma, p, q, comp, xi8, a_int8)


# ====================================================== fused primitives

def fused_primitives(mult, plan: PairPanelPlan, ncc: int,
                     b_fused: torch.Tensor, gp: GroupedPairs = None, *,
                     slot_group: np.ndarray = None,
                     lane_mask: np.ndarray = None, psum=None,
                     sup_mask: torch.Tensor = None):
    """``core.TfqmrPrimitives`` over fused permuted panels
    [n_slots*LM, 2*LN'] (JAX: ``fused_primitives`` in 'c' without col_pad,
    and ``_fused_primitives_grouped``).

    ``multiply`` is ``mult`` (K2, or in 'z' the oz kernel's
    ``OzPairPanelMultiply``) followed, with column groups, by the grouped
    lane mask.  ``dotp`` and ``nrm2`` sum over each slot's rows and then
    over the slots of each group (or column) in the vectors' type, float32
    or float64 (``b_fused``'s), through a padded slot table (no atomics:
    the order is fixed), and cast the per-column results to float64, the
    JAX package's order of types.  ``axpy``/``xpay`` expand the per-column
    scalars to slots by a gather, in the vectors' type (JAX: its
    ``vdt == float64`` branch for 'z').  ``add_rhs(v, b, s)`` is ``v + s *
    b``.  ``b_fused`` is a vector of the layout (B, or v3): its rows, type
    and device size the tables; the primitives hold no vector.

    A shard of a sharded solve holds some of the slots (``b_fused`` has its
    rows): ``slot_group`` gives the group of each (-1 for a pad slot),
    ``lane_mask`` its rows of the grouped lane mask, and ``psum`` sums the
    float32 group partials over the shards, in place, once a ``dotp`` (re
    and im stacked) or ``nrm2``, before the remap to columns.

    With ``sup_mask`` (the fused live-slot mask [n_slots*LM, 2*LN'] of a
    superblock row merge, ``superblock.merged_mask_full`` through
    ``permute_x``, on the device) the plan runs in merged space: every
    multiply's output is multiplied by it, so junk products on dead merged
    slots never re-enter the recurrence, and the reductions stay exact
    because dead slots hold zeros.  With column groups the mask already
    holds the grouped lane mask, which cannot index merged cells and is
    not built (JAX: ``fused_primitives``' ``sup_mask``)."""
    from ..core import TfqmrPrimitives
    from .linalg import _segment_sum, columns

    lm, ln2 = plan.lm, plan.ln
    gsz = gp.group_size if gp is not None else 1
    ln0 = ln2 // gsz
    ngroups = gp.ngroups if gp is not None else ncc
    nslots, dev = b_fused.shape[0] // lm, b_fused.device
    vdt, f64 = b_fused.dtype, torch.float64
    if slot_group is None:
        slot_group = plan.col_of_new
    # pad slots gather from an extra group of zeros and sum into it
    pad = bool(np.any(slot_group < 0))
    slot_grp = torch.from_numpy(np.where(slot_group < 0, ngroups,
                                         slot_group)).to(dev)
    table = columns(slot_grp, ngroups + pad)
    # compressed column -> its (group, lane block) position
    gc = np.arange(ncc, dtype=np.int64)
    if gp is not None:
        for gi, grp in enumerate(gp.groups):
            gc[grp] = gi * gsz + np.arange(len(grp))
    gc = torch.from_numpy(gc).to(dev)
    if lane_mask is None and gp is not None and sup_mask is None:
        lane_mask = grouped_lane_mask(plan, gp)
    mask = (torch.from_numpy(lane_mask).to(dev)[:, None, :]
            if lane_mask is not None else None)

    def view3(v):
        v3 = v.view(nslots, lm, 2 * ln2)
        return v3[..., :ln2], v3[..., ln2:]

    def multiply(x):
        y = mult(x)
        if sup_mask is not None:
            return y * sup_mask
        if mask is None:
            return y
        return (y.view(nslots, lm, 2 * ln2) * mask).view(-1, 2 * ln2)

    def groupsum(p):
        """[nslots, LM, LN'] -> [ngroups, LN'], in the vectors' type."""
        return _segment_sum(p.sum(dim=1), table)[:ngroups]

    def to_columns(z):
        """[ngroups, LN'] group sums -> [ncc, LN] per-column float64."""
        return z.reshape(ngroups * gsz, ln0)[gc].to(f64)

    def dotp(x, y):
        xr, xi = view3(x)
        yr, yi = view3(y)
        zr, zi = groupsum(xr * yr - xi * yi), groupsum(xr * yi + xi * yr)
        if psum is not None:
            zr, zi = psum(torch.stack([zr, zi]))
        return to_columns(zr), to_columns(zi)

    def nrm2(x):
        xr, xi = view3(x)
        z = groupsum(xr * xr + xi * xi)
        return to_columns(z if psum is None else psum(z))

    def scale(a):
        """[ncc, LN] float64 scalars -> [nslots, 1, LN'] in the vectors'
        type."""
        def expand(v):
            flat = torch.zeros(((ngroups + pad) * gsz, ln0), dtype=vdt,
                               device=dev)
            flat[gc] = v.to(vdt)
            return flat.view(ngroups + pad, ln2)[slot_grp][:, None, :]
        return expand(a[0]), expand(a[1])

    def fuse(re, im):
        return torch.cat([re, im], dim=2).view(-1, 2 * ln2)

    def axpy(y, x, a):
        ar, ai = scale(a)
        xr, xi = view3(x)
        yr, yi = view3(y)
        return fuse(ar * xr - ai * xi + yr, ai * xr + ar * xi + yi)

    def xpay(y, a, x):
        ar, ai = scale(a)
        xr, xi = view3(x)
        yr, yi = view3(y)
        return fuse(xr + ar * yr - ai * yi, xi + ai * yr + ar * yi)

    def add_rhs(v, b, scal):
        return v + scal * b

    return TfqmrPrimitives(multiply=multiply, dotp=dotp, nrm2=nrm2,
                           axpy=axpy, xpay=xpay, add_rhs=add_rhs)

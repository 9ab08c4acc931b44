"""Host tables of the staged panel kernels K2 (``csrc/pairpanel_tiles.cu``)
and K3 (``csrc/rowtile_spmm.cu``), which share ``csrc/panel_stage.cuh``.

Both kernels multiply fused A panels, one per tile of ``rlm`` output rows,
with the X blocks each tile lists (``xloc`` / ``xcols``, ascending, padded
to ``ku``).  This module builds, on the host and from the pattern only,

- ``depth_major``: the layout the kernels stage A from, [ntiles, ku*LM,
  2*rlm] (a depth row holds the re entries, then the im entries), so that a
  stage's A slice is contiguous rows;
- ``unit_tables``: the work units of a CTA of ``bm`` rows.  Where a tile
  has fewer rows than the CTA, ``nt = bm // rlm`` whole tiles sit side by
  side in a unit (a *group*).  On wide lanes the group's X blocks are the
  ascending union of its tiles' lists, each staged once; ``ukidx`` says
  where a union step's block sits in each tile's panel, or -1.  On narrow
  lanes every tile stages its own blocks (step s is its s-th block): a
  union of many short tiles would only add steps.  Padding entries of the
  lists are left out: they multiply zeros;
- ``work_list``: the units by lanes, (group, first row, first lane), dealt
  to one wave of persistent CTAs so that their steps come out even (longest
  unit first, to the CTA with the least work);
- ``walk``: the plain PyTorch walker over those tables, for the tests.  It
  sums each tile's blocks in the tile's own ascending order, as the kernel
  does, and counts how often the work list writes each output.

The bf16 split modes of both kernels run ``csrc/panel_mma.cuh`` over the
same tables at their own CTA shapes (``mma_shape``; the union tables at
every lane count), with A split once into bf16 planes (``bf16_planes``).

The oz kernel of K1's Ozaki modes (``csrc/pairpanel_oz.cu``) uses none of
these tables: a CTA owns 16 rows by 8 or 16 lanes of one tile and reads the
tile's ``xloc`` and ``kcount`` itself, the CTAs of a tile adjacent in a
one-dimensional grid.  A unit of several short tiles side by side would not
fit it: the kernel keeps an accumulator set for each slice product (or
diagonal) of its rows, up to 45 of them, so a unit's rows would multiply its
registers, and it needs the pack's tiles, which the 'z' route makes 16 or
32 rows tall anyway.

Units stay whole: where equal units leave a last, partly filled round, a
CTA alone on an SM runs at nearly the rate of two, so that round costs about
half a unit's time, and a half unit cut along the lanes and run by half of a
CTA's warps took longer on the card than the whole one (PERF.md).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

# CTA shapes (rows, lanes) of ``panel_stage.cuh``'s dispatch_shape: wide for
# c >= 64 lanes a plane (one X slab a unit: the union tables), narrow below
# (a slab for each tile).
WIDE, NARROW = (64, 64), (32, 8)
# units of one CTA's run whose headers fit its shared memory (kMaxRun)
MAX_RUN = 64


# CTA shapes of the bf16 split modes' tensor-core product
# (``csrc/panel_mma.cuh``): 64 rows (four m16 blocks) by 64 lanes for
# c >= 64, else by 16; its units always share one X slab (the union tables).
MMA_WIDE, MMA_NARROW = (64, 64), (64, 16)


def cta_shape(c: int) -> tuple:
    """(rows, lanes) of the CTA that multiplies planes of ``c`` lanes."""
    return WIDE if c >= WIDE[1] else NARROW


def mma_shape(c: int) -> tuple:
    """(rows, lanes) of the split modes' CTA for planes of ``c`` lanes."""
    return MMA_WIDE if c >= MMA_WIDE[1] else MMA_NARROW


def depth_major(panels: torch.Tensor) -> torch.Tensor:
    """Fused panels [ntiles, 2*rlm, ku*LM] -> [ntiles, ku*LM, 2*rlm],
    contiguous."""
    return panels.transpose(1, 2).contiguous()


def bf16_planes(a_dm: torch.Tensor, precision: str) -> torch.Tensor:
    """The bf16 planes of depth-major float32 panels [ntiles, ku*LM, 2*rlm]
    in a split mode (``pairpanel.split_planes``: 1, 2 or 3 planes), laid out
    as the tensor-core product loads them: int32 [planes, ntiles, ku*LM/2,
    2*rlm], word (d, r) holding the bf16 entries of depth rows 2d (low half)
    and 2d+1 (high half) of column r, the pair one mma fragment register
    takes.  Made once per A."""
    from .pairpanel import split_planes

    nt, kd, cols = a_dm.shape
    if kd % 2:
        raise ValueError(f"the panels' depth {kd} is odd")
    planes = torch.stack(split_planes(a_dm, precision))
    bits = planes.to(torch.bfloat16).view(torch.int16)   # exact: bf16 values
    pairs = bits.reshape(-1, nt, kd // 2, 2, cols).transpose(3, 4)
    return pairs.contiguous().view(torch.int32).reshape(-1, nt, kd // 2,
                                                         cols)


@dataclasses.dataclass
class UnitTables:
    """The work units of CTAs of ``bm`` rows over tiles of ``rlm`` rows.

    Group g holds tiles ``g*nt : (g+1)*nt``; at its step s < ucount[g]
    tile n multiplies block ``ukidx[g, s, n]`` of its panel (-1: none) with
    X block ``uslot[g, s, n]``.  With ``union`` the step's X block is the
    same for all n (the ascending union of the tiles' lists); without, it
    is each tile's own s-th block.  A tile taller than the CTA is one group
    of ``row_blocks`` units."""

    bm: int
    rlm: int
    union: bool
    nt: int                 # tiles side by side in a unit
    row_blocks: int         # units per group along the rows
    ksteps: int             # steps, padded to the longest group
    uslot: np.ndarray       # int32[ngroups, ksteps, nt]
    ukidx: np.ndarray       # int32[ngroups, ksteps, nt]
    ucount: np.ndarray      # int32[ngroups], >= 1

    @property
    def ngroups(self) -> int:
        return int(self.ucount.shape[0])

    @property
    def staged_x_blocks(self) -> int:
        """X blocks staged per column block of lanes."""
        n = self.ucount.sum() if self.union else (self.ukidx >= 0).sum()
        return int(n) * self.row_blocks


def unit_tables(xloc: np.ndarray, kcount: np.ndarray, rlm: int, bm: int,
                union: bool) -> UnitTables:
    """The unit tables for tile lists ``xloc`` [ntiles, ku], of which the
    first ``kcount[t]`` entries of row t are real and ascending."""
    xloc = np.asarray(xloc, np.int64)
    kcount = np.asarray(kcount, np.int64)
    ntiles = xloc.shape[0]
    if rlm <= 0 or rlm % 4 or bm % 4:
        raise ValueError(f"tile rows {rlm} and CTA rows {bm} must be "
                         f"positive multiples of 4")
    nt = bm // rlm if rlm < bm else 1
    row_blocks = -(-rlm // bm)
    ngroups = -(-ntiles // nt)
    slots, where = [], []           # per group: [steps, nt] X block, index
    for g in range(ngroups):
        lists = [xloc[t, :kcount[t]] for t in range(g * nt,
                                                    min((g + 1) * nt, ntiles))]
        if any(np.any(np.diff(v) <= 0) for v in lists):
            raise ValueError("a tile's block list is not strictly ascending")
        if union:
            u = np.unique(np.concatenate(lists))
            steps = max(u.shape[0], 1)
            slot = np.zeros((steps, nt), np.int64)
            slot[:u.shape[0]] = u[:, None]
        else:
            steps = max(max(v.shape[0] for v in lists), 1)
            slot = np.zeros((steps, nt), np.int64)
        idx = np.full((steps, nt), -1, np.int64)
        for n, v in enumerate(lists):
            at = np.searchsorted(u, v) if union else np.arange(v.shape[0])
            idx[at, n] = np.arange(v.shape[0])
            slot[at, n] = v
        slots.append(slot)
        where.append(idx)
    ucount = np.array([v.shape[0] for v in slots], np.int32)
    ksteps = int(ucount.max()) if ngroups else 1
    uslot = np.zeros((ngroups, ksteps, nt), np.int32)
    ukidx = np.full((ngroups, ksteps, nt), -1, np.int32)
    for g, (slot, idx) in enumerate(zip(slots, where)):
        uslot[g, :slot.shape[0]] = slot
        ukidx[g, :idx.shape[0]] = idx
    return UnitTables(bm=bm, rlm=rlm, union=union, nt=nt,
                      row_blocks=row_blocks, ksteps=ksteps, uslot=uslot,
                      ukidx=ukidx, ucount=ucount)


def unit_tables_for(xloc: np.ndarray, kcount: np.ndarray, rlm: int,
                    c: int) -> UnitTables:
    """The unit tables of the CTA shape that multiplies ``c`` lanes."""
    shape = cta_shape(c)
    return unit_tables(xloc, kcount, rlm, shape[0], union=shape == WIDE)


def work_list(tables: UnitTables, c: int, bn: int, slots: int,
              max_run: int = MAX_RUN) -> tuple:
    """(items int32[n, 4], cta_start int32[nctas + 1]): every unit of every
    column block of ``bn`` lanes once, as (group, first row in the tile,
    first lane, 0); CTA b runs items ``cta_start[b]:cta_start[b + 1]``.
    One wave of ``slots`` CTAs where ``max_run`` allows it.  A unit costs
    its group's steps, and the units are dealt longest first, each to the
    CTA with the least work so far, so no CTA ends more than one unit's
    steps after another; units of equal cost go round in turn.  A CTA runs
    its units in the order of tiles and lanes."""
    if slots < 1 or max_run < 1:
        raise ValueError("slots and max_run must be positive")
    units = tables.ngroups * tables.row_blocks
    col_blocks = -(-c // bn)
    n = units * col_blocks
    unit, cb = np.divmod(np.arange(n, dtype=np.int64), col_blocks)
    items = np.zeros((n, 4), np.int32)
    items[:, 0] = unit // tables.row_blocks
    items[:, 1] = (unit % tables.row_blocks) * tables.bm
    items[:, 2] = cb * bn
    nctas = max(min(n, slots), -(-n // max_run), 1)
    steps = tables.ucount[items[:, 0]].tolist()
    runs = [[] for _ in range(nctas)]
    heap = [(0, b) for b in range(nctas)]       # (steps so far, CTA)
    for i in np.argsort(-tables.ucount[items[:, 0]], kind="stable").tolist():
        load, b = heapq.heappop(heap)
        runs[b].append(i)
        if len(runs[b]) < max_run:              # a full CTA takes no more
            heapq.heappush(heap, (load + steps[i], b))
    order = np.array([i for run in runs for i in sorted(run)], np.int64)
    cta_start = np.concatenate(
        [[0], np.cumsum([len(run) for run in runs])]).astype(np.int32)
    return np.ascontiguousarray(items[order]), cta_start


def walk(tables: UnitTables, items: np.ndarray, a_dm: torch.Tensor,
         x_re: torch.Tensor, x_im: torch.Tensor, lm: int, n_rows: int,
         bn: int) -> tuple:
    """Plain PyTorch walk of the unit tables and the work list: (y_re, y_im,
    writes), planes [n_rows, c] and how often each output was written.
    Every tile's blocks are summed in its own ascending order, one product
    per step; unmasked."""
    t = tables
    rlm, nt, bm = t.rlm, t.nt, t.bm
    ntiles, c = a_dm.shape[0], x_re.shape[1]
    ku = a_dm.shape[1] // lm
    a = a_dm.reshape(ntiles, ku, lm, 2 * rlm)
    xb = torch.cat([x_re, x_im], dim=1).reshape(-1, lm, 2 * c)
    tiles = np.minimum(np.arange(t.ngroups)[:, None] * nt + np.arange(nt),
                       ntiles - 1)
    acc = a.new_zeros((t.ngroups, nt, 2 * rlm, 2 * c))
    for s in range(t.ksteps):
        kid = t.ukidx[:, s, :].astype(np.int64)
        live = torch.from_numpy((kid >= 0) & (s < t.ucount)[:, None])
        asl = a[torch.from_numpy(tiles), torch.from_numpy(np.maximum(kid, 0))]
        xs = xb[torch.from_numpy(t.uslot[:, s].astype(np.int64))]
        prod = torch.matmul(asl.transpose(2, 3), xs)
        acc += torch.where(live[:, :, None, None], prod, 0.0)
    p, q = acc[:, :, :rlm], acc[:, :, rlm:]
    g_re = p[..., :c] - q[..., c:]                # [ngroups, nt, rlm, c]
    g_im = p[..., c:] + q[..., :c]
    y_re, y_im = x_re.new_zeros((n_rows, c)), x_re.new_zeros((n_rows, c))
    writes = np.zeros((n_rows, c), np.int64)
    r = np.arange(bm)
    for g, i0, j0, _ in np.asarray(items).tolist():
        n, i = (r // rlm, r % rlm) if rlm < bm else (0 * r, i0 + r)
        tile = g * nt + n
        row = tile * rlm + i
        ok = (n < nt) & (i < rlm) & (tile < ntiles) & (row < n_rows)
        j1 = min(j0 + bn, c)
        y_re[row[ok], j0:j1] = g_re[g, n[ok], i[ok], j0:j1]
        y_im[row[ok], j0:j1] = g_im[g, n[ok], i[ok], j0:j1]
        writes[row[ok], j0:j1] += 1
    return y_re, y_im, writes


class PanelLaunch:
    """What a wrapper of K2 or K3 hands its kernel besides the operands:
    the unit tables on the device and, from the first launch on, the work
    list for the CTAs the card holds at once (``slots``; by default what
    the library reports for the kernel, ``slots_fn(bm, bn, lm, c)``), or
    the work list given as ``work`` (items, cta_start).  ``shape`` is the
    kernel's CTA (rows, lanes), by default ``cta_shape(c)``."""

    def __init__(self, tables: UnitTables, lm: int, c: int, device,
                 slots: int = None, work: tuple = None, shape: tuple = None):
        self.tables, self.lm, self.c = tables, int(lm), int(c)
        self.bm, self.bn = shape or cta_shape(c)
        if tables.bm != self.bm:
            raise ValueError(f"unit tables for CTAs of {tables.bm} rows, the "
                             f"kernel runs {self.bm}")
        self.slots = slots
        self.device = torch.device(device)
        self._tables = tuple(
            torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for v in (tables.uslot, tables.ukidx, tables.ucount))
        self._work = self._args = None
        if work is not None:
            self._upload(*work)

    def _upload(self, items: np.ndarray, cta_start: np.ndarray):
        self._work = tuple(
            torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(self.device)
            for v in (items, cta_start))
        self._args = (tuple(v.data_ptr() for v in self._tables + self._work),
                      int(cta_start.shape[0]) - 1)

    def args(self, slots_fn) -> tuple:
        """(pointers of uslot, ukidx, ucount, items, cta_start; nctas)."""
        if self._args is None:
            slots = self.slots
            if slots is None:
                slots = slots_fn(self.bm, self.bn, self.lm, self.c)
                if slots <= 0:
                    raise RuntimeError(f"the kernel's occupancy query "
                                       f"returned {slots}")
            self._upload(*work_list(self.tables, self.c, self.bn, slots))
        return self._args

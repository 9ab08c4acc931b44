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

The bf16 split modes of both kernels run ``csrc/panel_mma.cuh``, a
warpgroup product fed by TMA, over the union tables at their own CTA
shapes (``mma_shape``, at every lane count) and work list, with A split
once an upload into slabs staged as the kernel stages them
(``bf16_planes``) and X split once a multiply by the split pass
``XSplit`` (``csrc/split_x_bf16.cu``) into lane-major planes
(``x_planes``); ``SplitOperands`` holds both and their tensor maps.

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

import ctypes
import dataclasses
import heapq

import numpy as np
import torch

from .. import launch_counts
from ..errors import Status, TfqmrgpuError, encode_status

# CTA shapes (rows, lanes) of ``panel_stage.cuh``'s dispatch_shape: wide for
# c >= 64 lanes a plane (one X slab a unit: the union tables), narrow below
# (a slab for each tile).
WIDE, NARROW = (64, 64), (32, 8)
# units of one CTA's run whose headers fit its shared memory (kMaxRun)
MAX_RUN = 64


# CTA shapes of the bf16 split modes' warpgroup product
# (``csrc/panel_mma.cuh``): 64 rows (one wgmma M) by 128 lanes (two
# warpgroups of 64 lanes) for c > 64, else by 32 (two of 16); its units
# always share one X slab (the union tables).
MMA_WIDE, MMA_NARROW = (64, 128), (64, 32)


def cta_shape(c: int) -> tuple:
    """(rows, lanes) of the CTA that multiplies planes of ``c`` lanes."""
    return WIDE if c >= WIDE[1] else NARROW


def mma_shape(c: int) -> tuple:
    """(rows, lanes) of the split modes' CTA for planes of ``c`` lanes: wide
    above 64 lanes, where at most half of its lanes idle."""
    return MMA_WIDE if c > 64 else MMA_NARROW


def mma_step_rows(lm: int) -> int:
    """Depth rows of a union step in the split product: LM, and 16 (the
    wgmma depth) at LM 4 and 8, the rows past LM zero."""
    return max(int(lm), 16)


def mma_stage_rows(lm: int) -> int:
    """Depth rows of a stage of the split product's ring (``csrc/
    panel_mma.cuh``, stage_rows, which refuses another): 32 (two wgmma
    depths) where a step holds them, else 16."""
    return 32 if mma_step_rows(lm) % 32 == 0 else 16


def depth_major(panels: torch.Tensor) -> torch.Tensor:
    """Fused panels [ntiles, 2*rlm, ku*LM] -> [ntiles, ku*LM, 2*rlm],
    contiguous."""
    return panels.transpose(1, 2).contiguous()


def bf16_parts(v: torch.Tensor, precision: str) -> tuple:
    """The bf16 planes of a float32 tensor in a split mode, as bfloat16
    tensors: the values of ``pairpanel.split_planes`` to the bit, NaN
    included ('bf16' keeps the upper half of ``rn16_f32``; the other modes'
    planes are bfloat16 conversions, which turn the hi plane's NaN into
    0xFFFF)."""
    from .pairpanel import rn16_f32, split_bf16x2, split_bf16x3

    if precision == "bf16":
        hi = rn16_f32(v).view(torch.int32) >> 16
        return (hi.to(torch.int16).view(torch.bfloat16),)
    return split_bf16x3(v) if precision == "bf16x6" else split_bf16x2(v)


def slab_rows(tables: UnitTables, ntiles: int) -> tuple:
    """Where the rows of the split product's A slabs come from: for slab s
    (group g, row block rb, union step u, in that order; group g's first is
    ``abase[g]``, its unit rb's ``abase[g] + rb*ucount[g]``) and unit row r
    < 64, (tile, row in the tile, block of the tile's list, live), each
    int64[nslabs, 64]; a row is dead past its tiles' rows or where its tile
    has no block at the step.  Returns (tile, row, kidx, live, abase)."""
    t = tables
    per = t.ucount.astype(np.int64) * t.row_blocks
    abase = np.concatenate([[0], np.cumsum(per)[:-1]]).astype(np.int64)
    g = np.repeat(np.arange(t.ngroups), per)
    within = np.arange(int(per.sum())) - abase[g]
    rb, u = np.divmod(within, t.ucount[g].astype(np.int64))
    r = np.arange(t.bm)
    if t.nt > 1:
        n = np.broadcast_to(r // t.rlm, (g.shape[0], t.bm))
        i = np.broadcast_to(r % t.rlm, (g.shape[0], t.bm))
    else:
        n = np.zeros((g.shape[0], t.bm), np.int64)
        i = rb[:, None] * t.bm + r
    nc = np.minimum(n, t.nt - 1)
    tile = g[:, None] * t.nt + n
    kidx = t.ukidx[g[:, None], u[:, None], nc].astype(np.int64)
    live = (n < t.nt) & (tile < ntiles) & (i < t.rlm) & (kidx >= 0)
    return (np.where(live, tile, 0), np.where(live, i, 0),
            np.where(live, kidx, 0), live, abase.astype(np.int32))


def bf16_planes(a_fused: torch.Tensor, precision: str, tables: UnitTables,
                lm: int, kc: int) -> tuple:
    """A's bf16 planes for the split product, staged as it stages them:
    (slabs, abase).  ``a_fused`` holds the float32 panels [ntiles, 2*rlm,
    ku*LM] (re rows, then im rows); ``slabs`` is bfloat16 [nslabs * chunks
    * planes, 128, kc]: for slab s (``slab_rows``) and depth chunk ch of kc
    rows (chunks = ``mma_step_rows(lm) // kc``), box ``(s*chunks + ch) *
    planes + p`` holds plane p's rows 0-63 (the unit's re rows) and 64-127
    (its im rows), depth rows ch*kc.. of the step's block, zero for dead
    rows and depth past LM.  ``abase`` int32[ngroups].  The planes are
    ``pairpanel.split_planes``' values (``bf16_parts``).  Made once per A,
    on A's device."""
    ntiles, two_rlm, kd = a_fused.shape
    rlm, ku, klm = two_rlm // 2, kd // lm, mma_step_rows(lm)
    if klm % kc:
        raise ValueError(f"stages of {kc} rows do not divide steps of {klm}")
    tile, row, kidx, live, abase = slab_rows(tables, ntiles)
    dev = a_fused.device
    tile, row, kidx = (torch.from_numpy(v).to(dev) for v in (tile, row, kidx))
    blocks = a_fused.reshape(ntiles, two_rlm, ku, lm)
    rows = torch.stack([blocks[tile, row, kidx],
                        blocks[tile, row + rlm, kidx]], 1)  # [S, 2, 64, lm]
    rows = torch.where(torch.from_numpy(live).to(dev)[:, None, :, None],
                       rows, 0.0)
    rows = torch.nn.functional.pad(rows, (0, klm - lm))
    planes = torch.stack(bf16_parts(rows, precision), 1)  # [S, P, 2, 64, klm]
    nslabs, nplanes = planes.shape[:2]
    slabs = planes.reshape(nslabs, nplanes, 2 * tables.bm, klm // kc, kc)
    slabs = slabs.permute(0, 3, 1, 2, 4).reshape(-1, 2 * tables.bm, kc)
    return slabs.contiguous(), abase


def x_planes(x_re: torch.Tensor, x_im: torch.Tensor, lm: int,
             precision: str) -> torch.Tensor:
    """The plain version of the X split pass (``XSplit``): X's bf16 planes
    lane-major, [planes, nlb16, 2, 16, nblocks * klm] bfloat16 for the
    halves x_re and x_im [nblocks * lm, c] (klm = ``mma_step_rows(lm)``,
    nlb16 = ceil(c / 16)): element (p, jb, h, l, b*klm + i) is plane p of
    half h, lane 16*jb + l, row b*lm + i; rows past LM in a block and lanes
    past c zero.  ``pairpanel.split_planes``' values (``bf16_parts``)."""
    rows, c = x_re.shape
    klm, nlb16 = mma_step_rows(lm), -(-c // 16)
    x = torch.stack([x_re, x_im]).reshape(2, rows // lm, lm, c)
    x = torch.nn.functional.pad(x, (0, nlb16 * 16 - c, 0, klm - lm))
    planes = torch.stack(bf16_parts(x, precision))   # [P, 2, nb, klm, c16]
    planes = planes.reshape(planes.shape[0], 2, -1, nlb16, 16)
    return planes.permute(0, 3, 1, 4, 2).contiguous()


class XSplit(metaclass=launch_counts.CountedLaunches):
    """The X split pass of the split modes: X's bf16 planes once a
    multiply, lane-major as the product's TMA boxes read them
    (``x_planes``).  On a CUDA tensor it launches ``csrc/split_x_bf16.cu``
    into ``out``, a buffer of its own that the product's tensor map names;
    on a CPU tensor it returns ``x_planes``.  ``launches`` reads the
    kernel's launch counter on the card (``launch_counts``)."""

    _counters = {"launches": "x_split"}

    def __init__(self, rows: int, lm: int, c: int, precision: str, device):
        from .pairpanel import SPLIT_PRODUCTS

        self.rows, self.lm, self.c, self.precision = rows, lm, c, precision
        self.klm, self.nlb16 = mma_step_rows(lm), -(-c // 16)
        self.nplanes = {1: 1, 6: 3}.get(SPLIT_PRODUCTS[precision], 2)
        self.xrows = rows // lm * self.klm
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.out = (torch.empty((self.nplanes, self.nlb16, 2, 16, self.xrows),
                                dtype=torch.bfloat16, device=self.device)
                    if self.device.type == "cuda" else None)

    def _check(self, x_re: torch.Tensor, x_im: torch.Tensor):
        for t in (x_re, x_im):
            if (t.device != self.device or t.dtype != torch.float32
                    or tuple(t.shape) != (self.rows, self.c)
                    or t.stride(1) != 1 or t.stride(0) != x_re.stride(0)):
                raise ValueError(f"X halves must be ({self.rows}, {self.c}) "
                                 f"float32 rows of one stride on "
                                 f"{self.device}; got {tuple(t.shape)} "
                                 f"{t.dtype} strides {t.stride()}")

    def plain(self, x_re: torch.Tensor, x_im: torch.Tensor) -> torch.Tensor:
        return x_planes(x_re, x_im, self.lm, self.precision)

    def __call__(self, x_re: torch.Tensor, x_im: torch.Tensor,
                 lib=None) -> torch.Tensor:
        """The planes of (x_re, x_im); on the card written into ``out``
        through the kernel library ``lib`` (by default the built one)."""
        self._check(x_re, x_im)
        if self.device.type == "cpu":
            return self.plain(x_re, x_im)
        if lib is None:
            from .._build import load_kernels

            lib = load_kernels()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = lib.tfq_split_x_bf16(
                x_re.data_ptr(), x_im.data_ptr(), x_re.stride(0),
                self.out.data_ptr(), self.rows // self.lm, self.lm, self.klm,
                self.c, self.nlb16, self.nplanes, stream,
                launch_counts.pointer(self.device, "x_split"))
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"the X split pass returned {rc}")
        return self.out


class SplitOperands:
    """What a split-mode K2 or K3 hands its kernel besides the unit tables:
    A's slabs (``bf16_planes``) and the groups' first slabs on the device,
    the X split pass with its buffer, and, from the first launch on, the
    tensor maps of both (made once: the buffers never move).  ``rows`` is
    X's rows, ``c`` its lanes a half, ``lanes`` the CTA's."""

    def __init__(self, tables: UnitTables, a_fused: torch.Tensor,
                 precision: str, lm: int, c: int, rows: int, lanes: int):
        self.kc = mma_stage_rows(lm)
        self.lanes = lanes
        self.slabs, abase = bf16_planes(a_fused, precision, tables, lm,
                                        self.kc)
        self.abase = torch.from_numpy(abase).to(a_fused.device)
        self.xsplit = XSplit(rows, lm, c, precision, a_fused.device)
        self._maps = None

    def maps(self, lib) -> int:
        """The address of the two tensor maps (256 bytes of host memory)."""
        if self._maps is None:
            buf = ctypes.create_string_buffer(256)
            xs = self.xsplit
            rc = lib.tfq_panel_mma_maps(
                ctypes.addressof(buf), self.slabs.data_ptr(),
                self.slabs.shape[0], xs.out.data_ptr(), xs.xrows, xs.nlb16,
                xs.nplanes, self.kc, self.lanes)
            if rc != 0:
                raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                    f"the split product's tensor maps were "
                                    f"refused ({rc})")
            self._maps = buf
        return ctypes.addressof(self._maps)


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

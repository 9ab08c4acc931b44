"""Host-side 2-D partitioning of a plan over a (rows, cols) grid of ranks.

Counterpart of ``tfqmrgpu_tpu/parallel/partition.py``, bound to this
package's ``Plan``; on the same plan the tables are bit-identical.

Axes of parallelism (derived from the data flow; the reference is
single-device):

* **rows**: block rows of A/X/B are split into contiguous chunks balanced by
  nonzero-block count.  The SpMM needs X blocks from other row shards (the
  halo); pairs are translated to indices into the row-axis all-gather of X.
* **cols**: compressed block columns of X are split into contiguous chunks.
  Columns never couple inside the recurrence (a pair (iA, iX) for Y block iY
  always has colindx[iX] == colindx[iY]), so A is replicated over this axis
  and only the convergence maxima cross it.

All per-shard tables are padded to the max over shards, as the JAX
package's are (its ``shard_map`` needs static shapes); the port's sharded
solvers read each rank's real entries and keep padding only where a
collective needs equal sizes:

* padded X slots keep value 0 through every vector op (colindx pad -> 0, so
  their reduction contribution is 0*0);
* padded pairs point at an appended all-zero A block (index ``na_local``) and
  dump their product into an extra Y slot (index ``nmax``) that is sliced off;
* padded B slots carry zero data;
* padded scalar columns are masked via ``col_valid`` (inv_bn2 = 0 there).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from ..plan import Plan


def _host(v) -> np.ndarray:
    """A plan table (host array or tensor) as a numpy array."""
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _balanced_chunks(loads: np.ndarray, parts: int) -> np.ndarray:
    """Split range(len(loads)) into `parts` contiguous chunks with roughly
    equal total load.  Returns boundaries int64[parts+1]."""
    n = loads.shape[0]
    cum = np.concatenate([[0], np.cumsum(loads)]).astype(np.float64)
    total = cum[-1]
    bounds = np.zeros(parts + 1, dtype=np.int64)
    bounds[parts] = n
    for p in range(1, parts):
        target = total * p / parts
        bounds[p] = np.searchsorted(cum, target)
    # ensure monotone non-decreasing (degenerate loads)
    for p in range(1, parts + 1):
        bounds[p] = max(bounds[p], bounds[p - 1])
    return bounds


@dataclasses.dataclass
class RowPartition:
    """Per-shard index tables, stacked over the mesh axes."""

    pr: int                      # number of row shards
    pc: int                      # number of col shards
    nmax: int                    # max local X/Y blocks per shard
    namax: int                   # max local A blocks per row shard
    nbmax: int                   # max local B blocks per shard
    pmax: int                    # max local pairs per shard
    ncmax: int                   # max local compressed cols per col shard
    lm: int
    ln: int
    # [pr, pc, nmax]: global X index of each local slot (-1 = pad)
    blocks: np.ndarray
    colindx_local: np.ndarray    # [pr, pc, nmax] int32 (pad -> 0)
    x_valid: np.ndarray          # [pr, pc, nmax] bool
    # [pr, namax]: global A index (-1 = pad); +1 zero block appended on device
    a_blocks: np.ndarray
    # [pr, pc, pmax]
    pair_a: np.ndarray           # local A index (pad -> namax zero block)
    pair_xg: np.ndarray          # row-gathered X index = src_row*nmax + loc
    pair_y: np.ndarray           # local Y slot (pad -> nmax dump slot)
    # [pr, pc, nbmax]
    b_blocks: np.ndarray         # global B index (-1 = pad)
    subset_local: np.ndarray     # local X slot (pad -> 0 with zero data)
    # [pc, ncmax]
    col_valid: np.ndarray        # bool
    col_offset: np.ndarray       # [pc] first compressed col of the chunk
    row_bounds: np.ndarray       # [pr+1] block-row chunk boundaries
    col_bounds: np.ndarray       # [pc+1] compressed-column chunk boundaries

    @property
    def ncols(self) -> int:
        return int(self.col_bounds[-1])


def partition_plan(plan: Plan, pr: int, pc: int = 1) -> RowPartition:
    """Build the 2-D partition tables from a plan."""
    nnzb_x = plan.nnzb_x
    row_of_x = np.repeat(np.arange(plan.nrows, dtype=np.int64),
                         np.diff(plan.rowptr_x))
    colx = _host(plan.colindx).astype(np.int64)

    # chunk boundaries
    row_loads = np.bincount(row_of_x, minlength=plan.nrows)
    row_bounds = _balanced_chunks(row_loads, pr)
    col_loads = np.bincount(colx, minlength=plan.ncols)
    col_bounds = _balanced_chunks(col_loads, pc)

    rshard_of_row = np.searchsorted(row_bounds, np.arange(plan.nrows),
                                    side="right") - 1
    cshard_of_col = np.searchsorted(col_bounds, np.arange(plan.ncols),
                                    side="right") - 1
    rshard_of_x = rshard_of_row[row_of_x]
    cshard_of_x = cshard_of_col[colx]

    # local slot of every global X block (within its shard, storage order)
    loc_of_x = np.zeros(nnzb_x, dtype=np.int64)
    shard_blocks = [[None] * pc for _ in range(pr)]
    nmax = 0
    for r in range(pr):
        for c in range(pc):
            sel = np.flatnonzero((rshard_of_x == r) & (cshard_of_x == c))
            shard_blocks[r][c] = sel
            loc_of_x[sel] = np.arange(sel.shape[0])
            nmax = max(nmax, sel.shape[0])

    # A blocks per row shard
    row_of_a = np.repeat(np.arange(plan.nrows, dtype=np.int64),
                         np.diff(plan.rowptr_a))
    rshard_of_a = rshard_of_row[row_of_a]
    loc_of_a = np.zeros(plan.nnzb_a, dtype=np.int64)
    a_sel = []
    namax = 0
    for r in range(pr):
        sel = np.flatnonzero(rshard_of_a == r)
        a_sel.append(sel)
        loc_of_a[sel] = np.arange(sel.shape[0])
        namax = max(namax, sel.shape[0])

    # pairs: owner shard of a pair is the shard of its Y block
    counts = np.diff(_host(plan.starts)).astype(np.int64)
    pair_y_glob = np.repeat(np.arange(nnzb_x, dtype=np.int64), counts)
    pairs = _host(plan.pairs).reshape(-1, 2)
    pair_a_glob = pairs[:, 0].astype(np.int64)
    pair_x_glob = pairs[:, 1].astype(np.int64)
    pr_of_pair = rshard_of_x[pair_y_glob]
    pc_of_pair = cshard_of_x[pair_y_glob]

    # B blocks: shard of the X block they scatter into
    sub = _host(plan.subset).astype(np.int64)
    rshard_of_b = rshard_of_x[sub]
    cshard_of_b = cshard_of_x[sub]

    pmax = 0
    nbmax = 0
    for r in range(pr):
        for c in range(pc):
            pmax = max(pmax, int(np.sum((pr_of_pair == r) & (pc_of_pair == c))))
            nbmax = max(nbmax, int(np.sum((rshard_of_b == r) & (cshard_of_b == c))))
    pmax = max(pmax, 1)
    nbmax = max(nbmax, 1)
    nmax = max(nmax, 1)
    namax = max(namax, 1)

    ncols_local = np.diff(col_bounds)
    ncmax = max(int(ncols_local.max()), 1)

    blocks = np.full((pr, pc, nmax), -1, dtype=np.int32)
    colindx_local = np.zeros((pr, pc, nmax), dtype=np.int32)
    x_valid = np.zeros((pr, pc, nmax), dtype=bool)
    a_blocks = np.full((pr, namax), -1, dtype=np.int32)
    pair_a = np.full((pr, pc, pmax), namax, dtype=np.int32)   # -> zero block
    pair_xg = np.zeros((pr, pc, pmax), dtype=np.int32)
    pair_y = np.full((pr, pc, pmax), nmax, dtype=np.int32)    # -> dump slot
    b_blocks = np.full((pr, pc, nbmax), -1, dtype=np.int32)
    subset_local = np.zeros((pr, pc, nbmax), dtype=np.int32)
    col_valid = np.zeros((pc, ncmax), dtype=bool)
    col_offset = col_bounds[:-1].astype(np.int32)

    for c in range(pc):
        col_valid[c, : ncols_local[c]] = True

    for r in range(pr):
        sel_a = a_sel[r]
        a_blocks[r, : sel_a.shape[0]] = sel_a
        for c in range(pc):
            sel = shard_blocks[r][c]
            blocks[r, c, : sel.shape[0]] = sel
            colindx_local[r, c, : sel.shape[0]] = colx[sel] - col_bounds[c]
            x_valid[r, c, : sel.shape[0]] = True

            psel = np.flatnonzero((pr_of_pair == r) & (pc_of_pair == c))
            npair = psel.shape[0]
            pair_a[r, c, :npair] = loc_of_a[pair_a_glob[psel]]
            ix = pair_x_glob[psel]
            pair_xg[r, c, :npair] = rshard_of_x[ix] * nmax + loc_of_x[ix]
            pair_y[r, c, :npair] = loc_of_x[pair_y_glob[psel]]

            bsel = np.flatnonzero((rshard_of_b == r) & (cshard_of_b == c))
            b_blocks[r, c, : bsel.shape[0]] = bsel
            subset_local[r, c, : bsel.shape[0]] = loc_of_x[sub[bsel]]

    return RowPartition(
        pr=pr, pc=pc, nmax=nmax, namax=namax, nbmax=nbmax, pmax=pmax,
        ncmax=ncmax, lm=plan.lm, ln=plan.ln,
        blocks=blocks, colindx_local=colindx_local, x_valid=x_valid,
        a_blocks=a_blocks, pair_a=pair_a, pair_xg=pair_xg, pair_y=pair_y,
        b_blocks=b_blocks, subset_local=subset_local,
        col_valid=col_valid, col_offset=col_offset,
        row_bounds=row_bounds, col_bounds=col_bounds,
    )


def shard_blocks_array(part: RowPartition, arr: np.ndarray) -> np.ndarray:
    """Distribute a global block array [nnzb, ...] into padded per-shard form
    [pr, pc, nmax, ...] following ``part.blocks`` (pads -> 0)."""
    out = np.zeros((part.pr, part.pc, part.nmax) + arr.shape[1:],
                   dtype=arr.dtype)
    m = part.blocks >= 0
    out[m] = arr[part.blocks[m]]
    return out


def shard_b_array(part: RowPartition, arr: np.ndarray) -> np.ndarray:
    """Same for B blocks following ``part.b_blocks``."""
    out = np.zeros((part.pr, part.pc, part.nbmax) + arr.shape[1:],
                   dtype=arr.dtype)
    m = part.b_blocks >= 0
    out[m] = arr[part.b_blocks[m]]
    return out


def shard_a_array(part: RowPartition, arr: np.ndarray) -> np.ndarray:
    """A blocks per row shard [pr, namax+1, ...]; the appended last block is
    the all-zero block targeted by padded pairs."""
    out = np.zeros((part.pr, part.namax + 1) + arr.shape[1:], dtype=arr.dtype)
    m = part.a_blocks >= 0
    out[:, :-1][m] = arr[part.a_blocks[m]]
    return out


def unshard_blocks_array(part: RowPartition, arr: np.ndarray,
                         nnzb: int) -> np.ndarray:
    """Inverse of shard_blocks_array: [pr, pc, nmax, ...] -> [nnzb, ...]."""
    out = np.zeros((nnzb,) + arr.shape[3:], dtype=arr.dtype)
    m = part.blocks >= 0
    out[part.blocks[m]] = np.asarray(arr)[m]
    return out

"""Superblock row merge: f_row small block rows packed into one big block.

Counterpart of ``tfqmrgpu_tpu/ops/superblock.py``; the tables are the JAX
package's to the bit.  The reference's small block sizes (LM in {4, 8}: 9
of the 15 compiled pairs of allowed_block_sizes.h:4-18, the FD example's
LM = 8 among them) give the packed 'c' engine narrow tiles of many short
products.  Instead of a kernel tuned per size, as the reference's TUNE
table is (bench_tfqmrgpu.cu:529-547), the blocking changes: f_row block
rows of the pattern merge into LM' = f_row*LM superblocks (zero fill-in
where a fine block is absent), and K2 runs the merged plan at LM' = 16 or
32.  ``auto_f_row`` and the solver route by the card's measured rates
(``ops/rates.py``).

Exactness.  Fine A blocks scatter into the merged A cell at their
(row offset, column offset); fine X/Y blocks likewise.  A merged product
A'[I,K] @ X'[K,J] pairs fine A (i,k) with fine X (k',j) only at matching
column/row offset, so k == k' exactly (the placement is injective) and
only true fine products arise.  A product lands on a LIVE fine Y slot only
if (Y(i,j), A(i,k), X(k,j)) all exist, and then the fine pair list holds
that triple (the FULL-INTERSECTION invariant of the reference's
createPlan, tfqmrgpu.cu:183-230, checked here as ``pairpanel.pack_grouped``
checks it).  Products without a fine pair land on dead slots, which the
unmerge gather drops.  Dead X slots must be ZERO on entry
(``merge_xy_blocks`` writes them so; the solver masks every multiply's
output, ``pairpanel.fused_primitives``' ``sup_mask``): a nonzero dead X
slot would multiply a live fine A block into a live Y slot.

Composition.  The lane widening (LN' = f_col*LN) is
``pairpanel.pack_grouped``; compose it FIRST (it checks the invariant on
the fine lists), then row-merge the grouped cell problem (safe without a
second check: a grouped pair (A, g) is absent only when every column of g
lacks the fine intersection, so zeroing dead slots alone protects live
lanes; see ``pack_rowmerge(verify=False)``).

The merged pair lists are NOT full intersections (triples that only make
junk are dropped to save their MACs), so they must not be fed back into
``pack_grouped``.

Everything here is host numpy, apart from the ``merge_*`` and
``unmerge_xy_blocks`` gathers, which take numpy arrays or torch tensors
and return the same kind, on the tensor's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pairpanel import _cuthill_mckee, recover_geometry


@dataclasses.dataclass
class RowMerge:
    """Row-merge transform of a (possibly column-grouped) pair problem."""

    f_row: int
    lm: int                   # input block rows
    ln: int                   # input block lanes (already f_col-widened)
    lm2: int                  # merged block rows = f_row * lm
    n_in: int                 # input X/Y block (cell) count
    n_cells: int              # merged X/Y cell count
    n_acells: int             # merged A cell count
    # merged pair list (indices into the merged cell spaces)
    pair_a2: np.ndarray       # int64[nPairs2]
    pair_x2: np.ndarray       # int64[nPairs2]
    pair_y2: np.ndarray       # int64[nPairs2]
    # X/Y placement: input block -> (cell, row offset 0..f_row-1)
    cell_of: np.ndarray       # int64[n_in]
    rpos_of: np.ndarray       # int64[n_in]
    src_of: np.ndarray        # int64[n_cells, f_row]: input block or -1
    # A placement: input A block id -> merged A cell + offsets
    a_src: np.ndarray         # int64[nA_used] input A ids (unique, used)
    a_cell: np.ndarray        # int64[nA_used]
    a_rpos: np.ndarray        # int64[nA_used]
    a_cpos: np.ndarray        # int64[nA_used]
    # merged-problem geometry labels (for pack_pair_plan row_of/col_of)
    row_of2: np.ndarray       # int64[n_cells] super-row id
    col_of2: np.ndarray       # int64[n_cells] column label (input space)
    mac_inflation: float      # merged padded MACs / input pair MACs


def _a_adjacency(pair_a, pair_x, pair_y, row):
    """Unique used-A endpoints in row space: (a_ids, ai, aj).

    Verifies each used A block spans exactly one (target row, operand row)
    pair -- the same invariant pack_grouped enforces."""
    au, inv = np.unique(pair_a, return_inverse=True)
    nau = au.shape[0]
    ai = np.zeros(nau, np.int64)
    aj = np.zeros(nau, np.int64)
    ai[inv] = row[pair_y]
    aj[inv] = row[pair_x]
    nrow = int(row.max()) + 1
    if (np.unique(inv * np.int64(nrow) + row[pair_y]).shape[0] != nau
            or np.unique(inv * np.int64(nrow) + row[pair_x]).shape[0] != nau):
        raise ValueError("an A block spans multiple recovered rows")
    # distinct A ids sharing one (target row, operand row) endpoint pair
    # would scatter into the SAME merged slot (merge_a_blocks overwrites,
    # the fine multiply sums) -- a duplicate BSR entry, degenerate but
    # representable in bare plan files; refuse rather than merge wrong
    if np.unique(ai * np.int64(nrow) + aj).shape[0] != nau:
        raise ValueError("duplicate A blocks on one (row, col) endpoint "
                         "pair cannot be merged")
    return au, ai, aj


def group_rows_greedy(rowptr: np.ndarray, colind: np.ndarray, order,
                      f_row: int, window: int = 64) -> list:
    """Partition rows into groups of <= f_row, greedily clustering rows
    whose A-operand sets overlap (so the merged A cells stay dense).

    rowptr/colind: CSR of the row -> operand-row adjacency (one entry per
    merged A dependency).  order: preference order (Cuthill-McKee rank
    order keeps candidates spatially close).  Each seed considers the next
    ``window`` unused rows in order and adds the one maximizing
    |overlap with the group union| - 0.5 |new operands| -- measured on the
    golden plan this cuts the f_row=4 A fill from 5.8x (consecutive CM) to
    ~4.3x and the merged MACs by ~35%."""
    nrow = rowptr.shape[0] - 1
    used = np.zeros(nrow, bool)
    pos_in_order = np.asarray(order, np.int64)
    groups = []
    n_ord = pos_in_order.shape[0]
    for si in range(n_ord):
        s = int(pos_in_order[si])
        if used[s]:
            continue
        used[s] = True
        grp = [s]
        un = np.zeros(nrow, bool)
        un[colind[rowptr[s]:rowptr[s + 1]]] = True
        while len(grp) < f_row:
            # candidate window: next `window` unused rows in order
            cands = []
            j = si + 1
            while j < n_ord and len(cands) < window:
                r = int(pos_in_order[j])
                if not used[r]:
                    cands.append(r)
                j += 1
            if not cands:
                break
            # vectorized scores over the window: 1.5*|A(r) & un| - 0.5*deg
            cat = np.concatenate([colind[rowptr[r]:rowptr[r + 1]]
                                  for r in cands])
            lens = np.array([rowptr[r + 1] - rowptr[r] for r in cands],
                            np.int64)
            if cat.shape[0]:
                hits = un[cat]
                ends = np.cumsum(lens)
                inter = np.add.reduceat(
                    hits, np.concatenate([[0], ends[:-1]]))
                inter = np.where(lens > 0, inter, 0)
            else:
                inter = np.zeros(len(cands), np.int64)
            score = 1.5 * inter - 0.5 * lens
            best = cands[int(np.argmax(score))]
            grp.append(best)
            used[best] = True
            un[colind[rowptr[best]:rowptr[best + 1]]] = True
        groups.append(grp)
    return groups


def pack_rowmerge(pair_a, pair_x, pair_y, nnzb: int, lm: int, ln: int,
                  f_row: int, row_of=None, col_of=None,
                  verify: bool = True, window: int = 64) -> RowMerge:
    """Build the row-merge transform (see module docstring).

    pair lists index a SHARED X/Y block space of size nnzb (the framework's
    multiply is always X-shaped -> X-shaped, tfqmrgpu_core.hxx:49-56).
    row_of/col_of: per-block geometry labels; recovered from the pair list
    when absent (bare golden-plan files).  verify=False skips the
    full-intersection check (valid when the input is a pack_grouped cell
    problem, whose build already verified the fine lists)."""
    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    f_row = int(f_row)
    if f_row < 2:
        raise ValueError("row merging needs f_row >= 2")
    if row_of is None or col_of is None:
        row, col = recover_geometry(pa, px, py, nnzb)
    else:
        _, row = np.unique(np.asarray(row_of, np.int64), return_inverse=True)
        _, col = np.unique(np.asarray(col_of, np.int64), return_inverse=True)
    nrow, ncol = int(row.max()) + 1, int(col.max()) + 1
    if nrow < 2:
        raise ValueError("row merging needs >= 2 rows")

    # cell injectivity of the labels
    cell_key = row * np.int64(ncol) + col
    if np.unique(cell_key).shape[0] != nnzb:
        raise ValueError("recovered (row, col) labels collide")

    trip = (pa * nnzb + py) * nnzb + px
    if np.unique(trip).shape[0] != trip.shape[0]:
        raise ValueError("duplicate (iY, iA, iX) triples cannot be merged")

    au, ai, aj = _a_adjacency(pa, px, py, row)

    if verify:
        # full intersection: pairs(a) == cols(row ai) & cols(row aj),
        # exactly as pack_grouped verifies (pairpanel.py)
        nau = au.shape[0]
        inv = np.searchsorted(au, pa)
        pmb = np.zeros((nau, ncol), bool)
        pmb[inv, col[py]] = True
        rbool = np.zeros((nrow, ncol), bool)
        rbool[row, col] = True
        if not np.array_equal(pmb, rbool[ai] & rbool[aj]):
            raise ValueError(
                "pair list is not a full pattern intersection; row "
                "merging would change its semantics")

    # ---- super-row grouping (greedy A-overlap along the CM order)
    edge_order = np.lexsort((aj, ai))
    ai_s, aj_s = ai[edge_order], aj[edge_order]
    rowptr_adj = np.searchsorted(ai_s, np.arange(nrow + 1)).astype(np.int64)
    rank = _cuthill_mckee(nrow, ai, aj)
    order = np.argsort(rank)
    groups = group_rows_greedy(rowptr_adj, aj_s, order, f_row,
                               window=window)
    srow = np.empty(nrow, np.int64)
    rpos = np.empty(nrow, np.int64)
    for gid, grp in enumerate(groups):
        for p, r in enumerate(grp):
            srow[r] = gid
            rpos[r] = p
    n_srow = len(groups)

    # ---- merged X/Y cells: occupied (srow, col)
    occ = np.zeros((n_srow, ncol), bool)
    occ[srow[row], col] = True
    occ_r, occ_c = np.nonzero(occ)
    n_cells = occ_r.shape[0]
    cellid = np.full(n_srow * ncol, -1, np.int64)
    cellid[occ_r * ncol + occ_c] = np.arange(n_cells)
    cell_of = cellid[srow[row] * ncol + col]
    rpos_of = rpos[row]
    src_of = np.full((n_cells, f_row), -1, np.int64)
    src_of[cell_of, rpos_of] = np.arange(nnzb)

    # ---- merged A cells: occupied (srow_i, srow_j) among used A blocks
    sa_i, sa_j = srow[ai], srow[aj]
    akey = sa_i * np.int64(n_srow) + sa_j
    akeys, a_cell_of_used = np.unique(akey, return_inverse=True)
    n_acells = akeys.shape[0]

    # ---- merged pair list: unique preimage triples (junk-only triples,
    # i.e. (I,K,J) with no fine pair, are DROPPED -- their products land
    # only on dead slots, and skipping them saves their MACs)
    inv_a = np.searchsorted(au, pa)
    t_acell = a_cell_of_used[inv_a]
    t_x = cell_of[px]
    t_y = cell_of[py]
    tk = (t_acell * np.int64(n_cells) + t_y) * np.int64(n_cells) + t_x
    tuk = np.unique(tk)
    pair_a2 = tuk // (np.int64(n_cells) * np.int64(n_cells))
    rem = tuk % (np.int64(n_cells) * np.int64(n_cells))
    pair_y2 = rem // np.int64(n_cells)
    pair_x2 = rem % np.int64(n_cells)

    lm2 = f_row * lm
    mac_in = pa.shape[0] * lm * lm * ln
    mac_out = pair_a2.shape[0] * lm2 * lm2 * ln
    return RowMerge(
        f_row=f_row, lm=lm, ln=ln, lm2=lm2, n_in=nnzb, n_cells=n_cells,
        n_acells=n_acells, pair_a2=pair_a2, pair_x2=pair_x2,
        pair_y2=pair_y2, cell_of=cell_of, rpos_of=rpos_of, src_of=src_of,
        a_src=au, a_cell=a_cell_of_used, a_rpos=rpos[ai], a_cpos=rpos[aj],
        row_of2=occ_r.astype(np.int64), col_of2=occ_c.astype(np.int64),
        mac_inflation=float(mac_out / max(mac_in, 1)))


def _index(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)).to(like.device)


def merge_a_blocks(rm: RowMerge, a_blocks):
    """[>=max(a_src)+1, lm, lm] fine A data -> [n_acells, lm2, lm2] merged
    cells (absent fine positions zero).  numpy arrays or torch tensors."""
    f, lm = rm.f_row, rm.lm
    shape = (rm.n_acells, f, lm, f, lm)
    if torch.is_tensor(a_blocks):
        out = a_blocks.new_zeros(shape)
        out[_index(rm.a_cell, out), _index(rm.a_rpos, out), :,
            _index(rm.a_cpos, out), :] = a_blocks[_index(rm.a_src, out)]
    else:
        out = np.zeros(shape, dtype=a_blocks.dtype)
        out[rm.a_cell, rm.a_rpos, :, rm.a_cpos, :] = a_blocks[rm.a_src]
    return out.reshape(rm.n_acells, rm.lm2, rm.lm2)


def merge_xy_blocks(rm: RowMerge, blocks):
    """[n_in, lm, ln] -> [n_cells, lm2, ln] merged cells (dead row slots
    ZERO: required for exactness, see the module docstring).  numpy arrays
    or torch tensors."""
    src = rm.src_of.reshape(-1)
    live = (src >= 0)[:, None, None]
    take = np.maximum(src, 0)
    if torch.is_tensor(blocks):
        gathered = blocks[_index(take, blocks)].masked_fill(
            ~_index(live, blocks), 0)
    else:
        gathered = np.where(live, blocks[take], 0).astype(blocks.dtype,
                                                          copy=False)
    return gathered.reshape(rm.n_cells, rm.lm2, rm.ln)


def unmerge_xy_blocks(rm: RowMerge, cells):
    """[n_cells, lm2, ln] -> [n_in, lm, ln] (junk slots dropped).  numpy
    arrays or torch tensors."""
    c4 = cells.reshape(rm.n_cells, rm.f_row, rm.lm, rm.ln)
    if torch.is_tensor(cells):
        return c4[_index(rm.cell_of, cells), _index(rm.rpos_of, cells)]
    return np.asarray(c4)[rm.cell_of, rm.rpos_of]


def merged_x_mask(rm: RowMerge) -> np.ndarray:
    """float32[n_cells, lm2, 1] presence mask (1 on live fine row slots):
    multiply merged-space data by it before it goes back in as X, to keep
    dead slots zero."""
    m = (rm.src_of >= 0).astype(np.float32)
    return np.repeat(m, rm.lm, axis=1)[:, :, None]


def merged_mask_full(rm: RowMerge, gp=None) -> np.ndarray:
    """float32[n_cells, lm2, ln] live-slot mask of the merged problem: 1
    only on the (fine row slot, lane) positions that carry live fine data.
    With ``gp`` (the ``pack_grouped`` lane widening composed BEFORE the row
    merge) absent group lanes inside live row slots are masked too: the
    full mask the solver multiplies into every multiply's output, so junk
    products on dead slots never re-enter the Krylov recurrence."""
    rows = (rm.src_of >= 0)                                # [n_cells, f_row]
    if gp is None:
        m = np.repeat(rows.astype(np.float32), rm.lm, axis=1)[:, :, None]
        return np.ascontiguousarray(
            np.broadcast_to(m, (rm.n_cells, rm.lm2, rm.ln)))
    ln0 = rm.ln // gp.group_size
    lane = np.repeat((gp.src_of >= 0).astype(np.float32), ln0, axis=1)
    src = np.maximum(rm.src_of, 0)                         # [n_cells, f_row]
    full = lane[src] * rows[:, :, None]                    # [n_cells, f, ln]
    return np.ascontiguousarray(np.repeat(full, rm.lm, axis=1))


def auto_f_row(pair_a, pair_x, pair_y, nnzb: int, lm: int, ln: int,
               candidates=(2, 4), row_of=None, col_of=None,
               speed_tf=None, window: int = 64, precision: str = "c"):
    """Pick f_row by a simple cost model: merged MACs / (the engine's rate
    at the merged LM).  ``speed_tf`` maps lm2 -> TFlop/s; by default the
    card's measured rates (``ops/rates.py``), whose 'z' rows (the oz
    kernel's) are read only under TFQ_PAIRS_Z_OZ=1: otherwise a 'z'
    problem never merges, since 'z' runs K1 on the pair table.  Returns
    (f_row or 1, {f: RowMerge}); 1 means merging does not pay."""
    from . import rates
    from .pairpanel import z_oz_enabled

    if speed_tf is None:
        speed_tf = ({} if precision == "z" and not z_oz_enabled() else
                    dict(rates.ENGINE_TFLOPS.get(precision, {})))
    packs = {}
    best_f, best_cost = 1, None
    base_cost = 1.0 / rates.base_rate(precision, lm)
    for f in candidates:
        lm2 = f * lm
        if lm2 not in speed_tf or f < 2:
            continue
        try:
            rm = pack_rowmerge(pair_a, pair_x, pair_y, nnzb, lm, ln, f,
                               row_of=row_of, col_of=col_of, window=window)
        except ValueError:
            continue
        packs[f] = rm
        cost = rm.mac_inflation / speed_tf[lm2]
        if best_cost is None or cost < best_cost:
            best_f, best_cost = f, cost
    if best_cost is None or best_cost >= base_cost:
        return 1, packs
    return best_f, packs

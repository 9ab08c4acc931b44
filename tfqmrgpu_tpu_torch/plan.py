"""The one-time analysis step ("createPlan").

Turns the three BSR sparsity patterns (A, X, B) into the flat index tables
every solver iteration reuses:

* ``pairs``/``starts``  -- the multiplication pair list for Y = A @ X: for
  each nonzero block ``iY`` of Y (same pattern as X), the (iA, iX) pairs to
  multiply-accumulate, in Y order (tfqmrgpu.cu:183-230).
* ``subset``            -- for each nonzero block of B, the index of the X
  block at the same (row, col); validates B ⊆ X (tfqmrgpu.cu:233-251).
* ``colindx``           -- the compressed block-column index of each X
  block, with empty columns filtered out and a hard error when a column of
  B is entirely zero (tfqmrgpu.cu:254-339).

The tables are computed with vectorized numpy on the host, exactly as
``tfqmrgpu_tpu.plan`` computes them (the same values in the same order), and
then kept as int32 tensors on the plan's device.  The plan also keeps the
zero-based patterns ``rowptr_a``, ``colind_a`` and ``rowptr_x`` on the host
(numpy int64), which the panel layout and the row-tile packing read, and,
for ``Plan.save``, the rest of the JAX plan's arrays.  ``Plan.save`` and
``Plan.load`` use the JAX package's ``.npz`` keys and dtypes, so a plan
saved by either package loads in the other.

Every entry point of the package runs on the CUDA card unless it is given
``device="cpu"`` (``resolve_device``); without a card it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .bsr import Bsr
from .errors import Status, TfqmrgpuError, encode_status

MAX_BLOCK_COLUMNS = 1 << 16  # reference: colIndex_t = uint16_t (tfqmrgpu.hxx:59)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Without a card that is an error, never a quiet move to the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise TfqmrgpuError(
            encode_status(Status.NO_IMPLEMENTATION),
            "no CUDA device is available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _row_sorted_view(rowptr: np.ndarray, colind: np.ndarray):
    """Return (sorted_keys, perm, span, base): composite row-major keys
    sorted ascending, and ``perm`` mapping sorted slots back to nnz
    indices.  Works whether or not the rows are column-sorted."""
    nrows = rowptr.shape[0] - 1
    row_of = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(rowptr))
    span = np.int64(colind.max(initial=0)) - np.int64(colind.min(initial=0)) + 1
    base = np.int64(colind.min(initial=0))
    keys = row_of * span + (colind.astype(np.int64) - base)
    perm = np.argsort(keys, kind="stable")
    return keys[perm], perm, span, base


def _lookup(sorted_keys, perm, span, base, q_rows, q_cols):
    """For each (row, col) query return the pattern's nnz index, or -1.
    The reference does a linear ``find_in_array`` (bsr.hxx:27-39); this is
    one searchsorted over the composite keys."""
    if sorted_keys.shape[0] == 0:
        return np.full(q_rows.shape, -1, dtype=np.int64)
    q_off = q_cols.astype(np.int64) - base
    in_range = (q_off >= 0) & (q_off < span)
    q_keys = q_rows.astype(np.int64) * span + np.where(in_range, q_off, 0)
    pos = np.minimum(np.searchsorted(sorted_keys, q_keys),
                     sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == q_keys) & in_range
    return np.where(hit, perm[pos], -1)


@dataclasses.dataclass
class Plan:
    """Analysis products on one device, plus the statistics of the last
    solve (reference: tfqmrgpu_plan.hxx)."""

    nrows: int                # block rows (== block columns of A)
    ncols: int                # NON-EMPTY block columns of X
    nnzb_a: int
    nnzb_x: int
    nnzb_b: int
    starts: torch.Tensor      # int32[nnzbX+1]
    pairs: torch.Tensor       # int32[nPairs, 2] -- (iA, iX), in Y order
    subset: torch.Tensor      # int32[nnzbB] -- X index of every B block
    colindx: torch.Tensor     # int32[nnzbX] -- compressed column index
    rowptr_a: np.ndarray      # int64[nrows+1] -- host patterns, zero-based
    colind_a: np.ndarray      # int64[nnzbA]
    rowptr_x: np.ndarray      # int64[nrows+1]
    lm: int = 0
    ln: int = 0
    precision: str = "?"
    residuum_reached: float = -1.0
    iterations_needed: int = -1
    flops_performed: float = -1.0
    flops_performed_all: float = 0.0
    # the JAX plan's other arrays (host, int64), kept for ``save``
    colind_x: Optional[np.ndarray] = None
    rowptr_b: Optional[np.ndarray] = None
    colind_b: Optional[np.ndarray] = None
    original_colind_x: Optional[np.ndarray] = None  # column id per ncols

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])

    # ------------------------------------------------------ serialization
    # the JAX package's .npz layout (tfqmrgpu_tpu/plan.py:108-124): its
    # arrays in its dtypes, the counts and block dims as one int64 array

    _ARRAY_DTYPES = (("starts", np.uint32), ("pairs", np.uint32),
                     ("subset", np.uint32), ("colindx", np.uint16),
                     ("original_colind_x", np.int32), ("rowptr_x", np.int32),
                     ("colind_x", np.int32), ("rowptr_b", np.int32),
                     ("colind_b", np.int32), ("rowptr_a", np.int32),
                     ("colind_a", np.int32))
    _SCALAR_FIELDS = ("nrows", "ncols", "nnzb_a", "nnzb_x", "nnzb_b",
                      "lm", "ln")

    def save(self, path: str):
        """Write the analysis products to ``path`` (``.npz``), in the
        layout the JAX package's ``Plan.save`` writes."""
        payload = {}
        for k, dt in self._ARRAY_DTYPES:
            v = getattr(self, k)
            if v is None:
                raise ValueError(f"the plan has no {k!r} table to save; "
                                 "build it with create_plan or Plan.load")
            payload[k] = np.asarray(
                v.cpu().numpy() if torch.is_tensor(v) else v).astype(dt)
        payload["scalars"] = np.array(
            [getattr(self, k) for k in self._SCALAR_FIELDS], dtype=np.int64)
        payload["precision"] = np.array(self.precision)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str, device=None) -> "Plan":
        """A plan written by ``save`` (of either package), on ``device``
        (the CUDA card unless given)."""
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k, _ in cls._ARRAY_DTYPES}
            scalars = dict(zip(cls._SCALAR_FIELDS, z["scalars"].tolist()))
            precision = str(z["precision"])
        lm, ln = scalars.pop("lm"), scalars.pop("ln")
        plan = plan_on_device(**arrays, **scalars,
                              device=resolve_device(device))
        plan.lm, plan.ln, plan.precision = int(lm), int(ln), precision
        return plan

    @property
    def device(self) -> torch.device:
        return self.starts.device

    def pair_y(self) -> torch.Tensor:
        """int64[nPairs]: the Y block of every pair (ascending)."""
        counts = (self.starts[1:] - self.starts[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self.nnzb_x, device=self.device), counts)

    def memory_requirement_bytes(self, lm: int, ln: int,
                                 precision: str = "z") -> int:
        """Device-memory estimate of one solve, the analogue of
        tfqmrgpu_bsrsv_bufferSize's memcount mode (tfqmrgpu_core.hxx:49-99)
        and the same formula as the JAX package's.  PyTorch's caching
        allocator allocates for real, so the number is informational."""
        rsize = 8 if precision == "z" else 4
        nX, nB, nC = self.nnzb_x, self.nnzb_b, self.ncols
        vec = 2 * lm * ln * rsize
        total = 7 * nX * vec                      # v1, v4..v9
        total += nX * 2 * lm * ln * 4             # v3 shadow (always float32)
        total += nB * vec                         # v2 = B
        total += 5 * nC * 2 * ln * rsize          # rho, alfa, beta, c67, eta
        total += nC * 2 * ln * 8 + nC * ln * 8    # zvv/dvv result slots
        total += 2 * nC * ln * 8                  # tau, var
        total += nX * 2 + nB * 4 + nC * ln        # colindx, subset, status
        total += self.starts.nbytes + self.pairs.nbytes
        total += self.nnzb_a * 2 * lm * lm * rsize
        return int(total)

    def to(self, device) -> "Plan":
        """The same plan with its tables on ``device``."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device)
                     for k in ("starts", "pairs", "subset", "colindx")})


def plan_on_device(*, nrows, ncols, nnzb_a, nnzb_x, nnzb_b, starts, pairs,
                   subset, colindx, rowptr_a, colind_a, rowptr_x,
                   device, colind_x=None, rowptr_b=None, colind_b=None,
                   original_colind_x=None) -> Plan:
    """Wrap host index tables (any integer dtype) into a ``Plan`` whose
    multiplication tables are int32 tensors on ``device`` and whose
    patterns stay numpy int64 on the host."""
    def t(v):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(v).astype(np.int32))).to(device)

    def h(v):
        return (None if v is None else
                np.ascontiguousarray(np.asarray(v).astype(np.int64)))

    return Plan(nrows=int(nrows), ncols=int(ncols), nnzb_a=int(nnzb_a),
                nnzb_x=int(nnzb_x), nnzb_b=int(nnzb_b), starts=t(starts),
                pairs=t(np.asarray(pairs).reshape(-1, 2)), subset=t(subset),
                colindx=t(colindx), rowptr_a=h(rowptr_a),
                colind_a=h(colind_a), rowptr_x=h(rowptr_x),
                colind_x=h(colind_x), rowptr_b=h(rowptr_b),
                colind_b=h(colind_b), original_colind_x=h(original_colind_x))


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 16


def _device_key(device: torch.device) -> str:
    """``device`` with its index filled in, so that 'cuda' and the current
    'cuda:N' share cache entries."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def create_plan(a: Bsr, x: Bsr, b: Bsr, index_offset: int = 0,
                echo: int = 0, device=None) -> Plan:
    """Build the multiplication, subset and column-compression tables on
    ``device`` (the CUDA card unless given, see ``resolve_device``).

    Mirrors tfqmrgpu_bsrsv_createPlan (tfqmrgpu.cu:136-351), including its
    validation rules and error codes.  As in the JAX package, results are
    kept for the last 16 pattern triples (first in, first out); a hit
    returns a shallow copy with fresh statistics.  The key holds the
    device, so a plan is only ever handed out on the device it was built
    for.
    """
    device = resolve_device(device)
    key = (a.pattern_key(), x.pattern_key(), b.pattern_key(),
           int(index_offset), _device_key(device))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        if echo > 5:
            print("# create_plan: pattern-cache hit")
        return dataclasses.replace(
            hit, residuum_reached=-1.0, iterations_needed=-1,
            flops_performed=-1.0, flops_performed_all=0.0)
    plan = _build_plan(a, x, b, index_offset, echo, device)
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = plan
    return dataclasses.replace(plan)


def _build_plan(a: Bsr, x: Bsr, b: Bsr, index_offset: int, echo: int,
                device: torch.device) -> Plan:
    """``create_plan``'s tables, built anew on ``device``."""
    mb = a.nrows
    # static plausibility checks (tfqmrgpu.cu:166-172)
    if mb < 1:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 1), "mb < 1")
    if x.nnzb < 1:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 2), "nnzbX < 1")
    if b.nnzb > x.nnzb:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 3),
                            "nnzbB > nnzbX: B cannot be a subset of X")
    if a.nnzb > mb * mb:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 4),
                            "nnzbA > mb^2: A must be logically square")
    for op in (a, x, b):
        op.validate()
    if x.nrows != mb or b.nrows != mb:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 5),
                            "A, X, B must have the same number of block rows")

    c0f1 = int(index_offset)
    rowptr_a = a.rowptr.astype(np.int64) - c0f1
    rowptr_x = x.rowptr.astype(np.int64) - c0f1
    rowptr_b = b.rowptr.astype(np.int64) - c0f1
    colind_a = a.colind.astype(np.int64) - c0f1
    colind_x = x.colind.astype(np.int64) - c0f1
    colind_b = b.colind.astype(np.int64) - c0f1
    nnzb_x = x.nnzb
    skeys, perm, span, base = _row_sorted_view(rowptr_x, colind_x)

    # --- multiplication pair list (tfqmrgpu.cu:183-230): Y block iY at
    # (irow, jcol) pairs every A block (irow, k) with the X block (k, jcol)
    n_a_per_row = np.diff(rowptr_a)
    row_of_y = np.repeat(np.arange(mb, dtype=np.int64), np.diff(rowptr_x))
    combo = n_a_per_row[row_of_y]                     # A candidates per Y block
    m_total = int(combo.sum())
    iy_idx = np.repeat(np.arange(nnzb_x, dtype=np.int64), combo)
    group_start = np.cumsum(combo) - combo
    off = np.arange(m_total, dtype=np.int64) - np.repeat(group_start, combo)
    ia_idx = rowptr_a[row_of_y[iy_idx]] + off
    inzx = _lookup(skeys, perm, span, base, colind_a[ia_idx], colind_x[iy_idx])
    valid = inzx >= 0
    pairs = np.stack([ia_idx[valid], inzx[valid]], axis=1)
    starts = np.zeros(nnzb_x + 1, dtype=np.int64)
    np.cumsum(np.bincount(iy_idx[valid], minlength=nnzb_x), out=starts[1:])
    if echo > 6:
        print(f"# create_plan: found {pairs.shape[0]} pairs in A*X multiplication")

    # --- subset list, B ⊆ X check (tfqmrgpu.cu:233-251)
    row_of_b = np.repeat(np.arange(mb, dtype=np.int64), np.diff(rowptr_b))
    subset = _lookup(skeys, perm, span, base, row_of_b, colind_b)
    missing = subset < 0
    if np.any(missing):
        irow_bad = int(row_of_b[np.argmax(missing)])
        raise TfqmrgpuError(
            encode_status(Status.B_IS_NOT_SUBSET_OF_X, irow_bad),
            f"in row {irow_bad + c0f1} B has a block where X does not")

    # --- column compression -> colindx (tfqmrgpu.cu:254-339); the reference
    # works on the RAW column indices here, relying only on their range
    raw_cols_x = x.colind.astype(np.int64)
    min_col = int(raw_cols_x.min())
    nc = int(raw_cols_x.max()) - min_col + 1
    occupied = np.bincount(raw_cols_x - min_col, minlength=nc) > 0
    nb = int(occupied.sum())
    if nb > MAX_BLOCK_COLUMNS:
        raise TfqmrgpuError(
            encode_status(Status.UNDOCUMENTED_ERROR, 7),
            f"{nb} block columns exceed the colindx limit of {MAX_BLOCK_COLUMNS}")
    if nc > nb and echo > 0:
        print(f"# create_plan: found {nc - nb} empty columns in X!")
    translate = np.full(nc, -1, dtype=np.int64)
    translate[occupied] = np.arange(nb)
    colindx = translate[raw_cols_x - min_col]

    # at least one nonzero block of B per nonzero column of X
    # (tfqmrgpu.cu:316-337)
    b_col_occupancy = np.bincount(translate[raw_cols_x[subset] - min_col],
                                  minlength=nb)
    n_zero_cols_b = int((b_col_occupancy < 1).sum())
    if n_zero_cols_b > 0:
        raise TfqmrgpuError(
            encode_status(Status.B_HAS_A_ZERO_COLUMN, n_zero_cols_b),
            f"{n_zero_cols_b} columns of B are entirely zero "
            "(guaranteed breakdown)")

    return plan_on_device(nrows=mb, ncols=nb, nnzb_a=a.nnzb, nnzb_x=nnzb_x,
                          nnzb_b=b.nnzb, starts=starts, pairs=pairs,
                          subset=subset, colindx=colindx, rowptr_a=rowptr_a,
                          colind_a=colind_a, rowptr_x=rowptr_x, device=device,
                          colind_x=colind_x, rowptr_b=rowptr_b,
                          colind_b=colind_b,
                          original_colind_x=np.flatnonzero(occupied) + min_col)

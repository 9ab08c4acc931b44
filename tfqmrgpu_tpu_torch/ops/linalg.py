"""Per-column vector operations of the tfQMR recurrence.

All functions act on split-complex block vectors ``(re, im)`` of shape
``[nnzb, LM, LN]`` and per-RHS scalar fields of shape ``[nCols, LN]``.

Reductions (``dotp``, ``nrm2``) are segmented by block column: every block
contributes to the slot of its compressed column index ``colindx``
(reference: tfqmrgpu_linalg.hxx:480-541).  Per-block partials over LM are
taken in the data precision and summed across blocks in float64, as in the
reference.  The cross-block sum must be deterministic on the card, because
iteration counts are compared exactly, so it uses no atomics: ``Columns``
lists every column's blocks in a padded table built once per plan, and the
sum is one gather and one ``torch.sum`` over that table's rows.

These functions are the plain versions.  On the card the loop runs the
kernels of ``csrc/vector_passes.cu`` through ``VectorPasses``, which update
their first vector in place.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import launch_counts
from ..errors import Status, TfqmrgpuError, encode_status

Pair = tuple

# the runs a column's sum is cut into on the card (csrc/vector_passes.cu's
# kChunks), which ``VectorPasses.plain_column_sums`` repeats
SUM_CHUNKS = 128


@dataclasses.dataclass(frozen=True)
class Columns:
    """The column structure of an X-shaped vector, for the reductions."""

    colindx: torch.Tensor   # int32[nnzb]: compressed column of each block
    ncols: int
    table: torch.Tensor     # int64[ncols, width]: the blocks of each column,
    #                         padded with ``nnzb`` (a zero row)


def columns(colindx: torch.Tensor, ncols: int) -> Columns:
    """Build the padded column table of ``colindx`` on its device."""
    col = colindx.to(torch.int64)
    nnzb = int(col.shape[0])
    order = torch.sort(col, stable=True).indices          # blocks by column
    counts = torch.bincount(col, minlength=ncols)
    first = torch.cumsum(counts, 0) - counts
    width = max(int(counts.max()) if nnzb else 0, 1)
    slot = torch.arange(nnzb, device=col.device) - first[col[order]]
    table = torch.full((ncols, width), nnzb, dtype=torch.int64,
                       device=col.device)
    table[col[order], slot] = order
    return Columns(colindx=colindx, ncols=int(ncols), table=table)


def _segment_sum(p: torch.Tensor, cols: Columns) -> torch.Tensor:
    """[nnzb, LN] partials -> [ncols, LN] column sums, in a fixed order."""
    padded = torch.cat([p, p.new_zeros((1,) + p.shape[1:])])
    return padded[cols.table].sum(dim=1)


# ------------------------------------------------------------------ scatter

def add_rhs(v: Pair, b: Pair, scal: float, subset: torch.Tensor) -> Pair:
    """v[subset[i]] += scal * b[i]  (reference: add_RHS_kernel,
    tfqmrgpu_linalg.hxx:383-428).  ``subset`` holds one X slot per B block,
    so no index repeats and every sum is a single addition."""
    return (torch.index_add(v[0], 0, subset, b[0], alpha=scal),
            torch.index_add(v[1], 0, subset, b[1], alpha=scal))


def set_unit_blocks(nnzb: int, lm: int, ln: int, dtype, device="cpu",
                    re_part: float = 1.0, im_part: float = 0.0) -> Pair:
    """Blocks holding columns of the unit matrix: v[inzb, j % LM, j] = 1
    (reference: set_unit_blocks_kernel, tfqmrgpu_linalg.hxx:432-455)."""
    i = torch.arange(lm, device=device)[:, None]
    j = torch.arange(ln, device=device)[None, :]
    mask = (j % lm) == i
    blk_re = mask.to(dtype) * re_part
    blk_im = mask.to(dtype) * im_part
    return (blk_re.expand(nnzb, lm, ln).contiguous(),
            blk_im.expand(nnzb, lm, ln).contiguous())


# ------------------------------------------------------------- reductions

def dotp(x: Pair, y: Pair, cols: Columns) -> Pair:
    """Per-column unconjugated inner product  z[col] = sum_{blk in col} x.y,
    float64 (re, im) of shape [ncols, LN] (reference: dotp,
    tfqmrgpu_linalg.hxx:545-588)."""
    pr = (x[0] * y[0] - x[1] * y[1]).sum(dim=1).to(torch.float64)
    pi = (x[0] * y[1] + x[1] * y[0]).sum(dim=1).to(torch.float64)
    return _segment_sum(pr, cols), _segment_sum(pi, cols)


def nrm2(x: Pair, cols: Columns) -> torch.Tensor:
    """Per-column squared norm  d[col] = sum_{blk in col} |x|^2, float64
    [ncols, LN] (reference: nrm2, tfqmrgpu_linalg.hxx:590-626; the
    reference's "norm" is the squared 2-norm)."""
    p = (x[0] * x[0] + x[1] * x[1]).sum(dim=1).to(torch.float64)
    return _segment_sum(p, cols)


# ----------------------------------------------------------- axpy / xpay

def _gather_scalar(a: Pair, colindx: torch.Tensor, dtype) -> Pair:
    """a[colindx] broadcast over the LM axis -> [nnzb, 1, LN]."""
    return (a[0].to(dtype)[colindx][:, None, :],
            a[1].to(dtype)[colindx][:, None, :])


def axpy(y: Pair, x: Pair, a: Pair, colindx: torch.Tensor) -> Pair:
    """y := a[col] * x + y with a per-(column, RHS) complex scalar a
    (reference: col_axpay<ScaleX=true>, tfqmrgpu_linalg.hxx:629-685)."""
    ar, ai = _gather_scalar(a, colindx, y[0].dtype)
    return (ar * x[0] - ai * x[1] + y[0],
            ai * x[0] + ar * x[1] + y[1])


def xpay(y: Pair, a: Pair, x: Pair, colindx: torch.Tensor) -> Pair:
    """y := x + a[col] * y  (reference: col_axpay<ScaleX=false>,
    tfqmrgpu_linalg.hxx:629-704)."""
    ar, ai = _gather_scalar(a, colindx, y[0].dtype)
    return (x[0] + ar * y[0] - ai * y[1],
            x[1] + ai * y[0] + ar * y[1])


# ------------------------------------------------------ the loop's kernels

class VectorPasses(metaclass=launch_counts.CountedLaunches):
    """The vector passes of ``core.step`` over a plan's columns and B's
    ``subset``, as ``core.solve_core`` runs them on the card.

    On CUDA tensors each method launches its kernel of
    ``csrc/vector_passes.cu`` or raises: ``axpy``, ``xpay`` and ``add_rhs``
    write into their first vector's planes and return them (``core.step``
    never reads a carry vector again after the call that replaces it, so
    the loop graph copies none of these results); ``dotp`` and ``nrm2`` take
    each block's partial over LM, then each column's float64 sum in a fixed
    order.  On CPU tensors the ``plain_*`` versions run, which do the same
    in torch: the elementwise passes are this module's functions, written
    into the first vector, and the reductions repeat the kernels' order of
    sums to the bit (they differ from ``dotp`` / ``nrm2`` by that order
    only).  Signatures follow ``core.TfqmrPrimitives``.

    ``launches`` reads the four kernels' launch counters on the card
    (``launch_counts``), the other attributes each kernel's."""

    _counters = {"launches": ("vec_axpay", "vec_add_rhs", "vec_partials",
                              "vec_column_sums"),
                 "axpays": "vec_axpay", "scatters": "vec_add_rhs",
                 "partials": "vec_partials", "column_sums": "vec_column_sums"}

    def __init__(self, cols: Columns, subset: torch.Tensor):
        self.cols = cols
        self.colindx = cols.colindx.to(torch.int32).contiguous()
        self.subset = subset.to(torch.int32).contiguous()

    # ---- the kernels' wrappers

    def axpy(self, y: Pair, x: Pair, a: Pair) -> Pair:
        """y := a[col] * x + y, in place."""
        if y[0].device.type == "cpu":
            return self.plain_axpy(y, x, a)
        return self._axpay(y, x, a, scale_x=True)

    def xpay(self, y: Pair, a: Pair, x: Pair) -> Pair:
        """y := x + a[col] * y, in place."""
        if y[0].device.type == "cpu":
            return self.plain_xpay(y, a, x)
        return self._axpay(y, x, a, scale_x=False)

    def add_rhs(self, v: Pair, b: Pair, scal: float) -> Pair:
        """v[subset[i]] += scal * b[i], in place."""
        if v[0].device.type == "cpu":
            return self.plain_add_rhs(v, b, scal)
        nnzb, lm, ln = self._vector(v, "v")
        dt = v[0].dtype
        self._vector(b, "b", (int(self.subset.shape[0]), lm, ln), dt)
        self._run("tfq_vec_add_rhs", "vec_add_rhs", v[0].device,
                  *_ptrs(v), *_ptrs(b), self.subset.data_ptr(),
                  int(self.subset.shape[0]), lm, ln, float(scal),
                  int(dt == torch.float32))
        return v

    def dotp(self, x: Pair, y: Pair) -> Pair:
        """Per-column <x, y>, float64 (re, im) [ncols, LN]."""
        if y[0].device.type == "cpu":
            return self.plain_dotp(x, y)
        out = self._column_sums(self._partials(x, y))
        return out[0], out[1]

    def nrm2(self, x: Pair) -> torch.Tensor:
        """Per-column |x|^2, float64 [ncols, LN]."""
        if x[0].device.type == "cpu":
            return self.plain_nrm2(x)
        return self._column_sums(self._partials(x, None))[0]

    # ---- their plain versions

    def plain_axpy(self, y: Pair, x: Pair, a: Pair) -> Pair:
        return _into(y, axpy(y, x, a, self.colindx))

    def plain_xpay(self, y: Pair, a: Pair, x: Pair) -> Pair:
        return _into(y, xpay(y, a, x, self.colindx))

    def plain_add_rhs(self, v: Pair, b: Pair, scal: float) -> Pair:
        return _into(v, add_rhs(v, b, scal, self.subset))

    def plain_dotp(self, x: Pair, y: Pair) -> Pair:
        out = self.plain_column_sums(plain_partials(x, y))
        return out[0], out[1]

    def plain_nrm2(self, x: Pair) -> torch.Tensor:
        return self.plain_column_sums(plain_partials(x, None))[0]

    def plain_column_sums(self, part: torch.Tensor) -> torch.Tensor:
        """[planes, nnzb, LN] float64 partials -> [planes, ncols, LN]: run r
        of ``SUM_CHUNKS`` adds the table's slots [r k, (r + 1) k) in order
        from 0 (k = ceil(width / SUM_CHUNKS)), then run r + h is added into
        run r for h = SUM_CHUNKS / 2, ..., 1.  Padding adds a zero, which
        leaves a sum that starts from +0 as it is."""
        table = self.cols.table
        ncols, width = table.shape
        k = -(-width // SUM_CHUNKS)
        nnzb = part.shape[1]
        padded = torch.cat([part, part.new_zeros((part.shape[0], 1,
                                                  part.shape[2]))], dim=1)
        slots = torch.full((ncols, SUM_CHUNKS * k), nnzb, dtype=table.dtype,
                           device=table.device)
        slots[:, :width] = table
        g = padded[:, slots.view(ncols, SUM_CHUNKS, k)]
        acc = torch.zeros_like(g[:, :, :, 0])
        for j in range(k):
            acc = acc + g[:, :, :, j]
        while acc.shape[2] > 1:
            h = acc.shape[2] // 2
            acc = acc[:, :, :h] + acc[:, :, h:]
        return acc[:, :, 0]

    # ---- launches

    def _axpay(self, y: Pair, x: Pair, a: Pair, scale_x: bool) -> Pair:
        nnzb, lm, ln = self._vector(y, "y")
        dt = y[0].dtype
        self._vector(x, "x", (nnzb, lm, ln), dt)
        a = tuple(t.to(dt).contiguous() for t in a)
        self._vector(a, "a", (self.cols.ncols, ln), dt)
        if nnzb != self.colindx.shape[0]:
            raise ValueError(f"{nnzb} blocks against a column table of "
                             f"{self.colindx.shape[0]}")
        self._run("tfq_vec_axpay", "vec_axpay", y[0].device, *_ptrs(y),
                  *_ptrs(x), *_ptrs(a), self.colindx.data_ptr(), nnzb, lm,
                  ln, int(scale_x), int(dt == torch.float32))
        return y

    def _partials(self, x: Pair, y) -> torch.Tensor:
        """Each block's partial [planes, nnzb, LN] float64 (dotp: re, im;
        nrm2 with y None: |x|^2)."""
        nnzb, lm, ln = self._vector(x, "x")
        if y is not None:
            self._vector(y, "y", (nnzb, lm, ln))
        part = torch.empty((1 if y is None else 2, nnzb, ln),
                           dtype=torch.float64, device=x[0].device)
        f32 = torch.float32
        ys = (None, None) if y is None else _ptrs(y)
        self._run("tfq_vec_partials", "vec_partials", x[0].device, *_ptrs(x),
                  *ys, part.data_ptr(), nnzb, lm, ln, int(y is not None),
                  int(x[0].dtype == f32),
                  int(y is not None and y[0].dtype == f32))
        return part

    def _column_sums(self, part: torch.Tensor) -> torch.Tensor:
        planes, nnzb, ln = part.shape
        table = self.cols.table
        if nnzb != self.colindx.shape[0]:
            raise ValueError(f"{nnzb} blocks against a column table of "
                             f"{self.colindx.shape[0]}")
        out = torch.empty((planes, self.cols.ncols, ln), dtype=torch.float64,
                          device=part.device)
        self._run("tfq_vec_column_sums", "vec_column_sums", part.device,
                  part.data_ptr(), planes, nnzb, ln, table.data_ptr(),
                  self.cols.ncols, int(table.shape[1]), out.data_ptr())
        return out

    @staticmethod
    def _vector(v: Pair, what: str, shape: tuple = None, dtype=None) -> tuple:
        """The shape of an (re, im) pair of contiguous float32 / float64
        planes on a CUDA device, held to ``shape`` and ``dtype`` where
        given."""
        shape = tuple(v[0].shape) if shape is None else tuple(shape)
        dtype = v[0].dtype if dtype is None else dtype
        for t in v:
            if (tuple(t.shape) != shape or t.dtype != dtype
                    or dtype not in (torch.float32, torch.float64)
                    or not t.is_contiguous() or t.device != v[0].device):
                raise ValueError(
                    f"{what} must be contiguous {shape} float32 or float64 "
                    f"planes of one type and device; got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
        if v[0].device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no vector pass kernel for {v[0].device}")
        return shape

    @staticmethod
    def _run(entry: str, slot: str, dev: torch.device, *args):
        """Launch ``entry`` on the current stream with ``slot``'s counter."""
        from .._build import load_kernels

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(load_kernels(), entry)(
                *args, stream, launch_counts.pointer(dev, slot))
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"the vector pass {entry} returned {rc}")


def plain_partials(x: Pair, y) -> torch.Tensor:
    """``VectorPasses``' first stage in torch: each block's partial over LM,
    rows added in order from 0 in the products' precision, as float64
    [planes, nnzb, LN] (dotp: re, im; nrm2 with ``y`` None: |x|^2)."""
    if y is None:
        terms = (x[0] * x[0] + x[1] * x[1],)
    else:
        terms = (x[0] * y[0] - x[1] * y[1], x[0] * y[1] + x[1] * y[0])
    out = []
    for t in terms:
        acc = torch.zeros_like(t[:, 0])
        for m in range(t.shape[1]):
            acc = acc + t[:, m]
        out.append(acc.to(torch.float64))
    return torch.stack(out)


def _ptrs(v: Pair) -> tuple:
    return tuple(t.data_ptr() for t in v)


def _into(dst: Pair, src: Pair) -> Pair:
    for d, s in zip(dst, src):
        d.copy_(s)
    return dst


# ------------------------------------------------------------ flop models
# (reference flop accounting: tfqmrgpu_linalg.hxx:587,625,684,703)

def flops_dotp(nnzb: int, lm: int, ln: int) -> float:
    return nnzb * 4.0 * 2 * lm * ln


def flops_nrm2(nnzb: int, lm: int, ln: int) -> float:
    return nnzb * 4.0 * 1 * lm * ln


def flops_axpy(nnzb: int, lm: int, ln: int) -> float:
    return nnzb * 8.0 * lm * ln

"""The panel layout of X-shaped vectors, shared by the 'dense' and the
row-tile ('pallas') engines.

Counterpart of ``tfqmrgpu_tpu/ops/panel.py``.  A vector lives as dense
row panels

    v[mb*LM, ncc, LN]   (re, im planes)

where ``ncc`` is the number of compressed (non-empty) block columns of X and
positions outside X's sparsity pattern are zero.  The per-column reductions
become plain sums over axis 0, axpy/xpay become broadcasts, and B is
scattered into a panel once.  The multiply must keep the pattern: its
result is masked to X's blocks (the reference's pair-list truncation,
tfqmrgpu.cu:183-230).

``PanelLayout`` is host numpy, with the same tables as the JAX package's;
the primitives act on torch tensors on any device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from ..errors import Status, TfqmrgpuError, encode_status

Pair = tuple


@dataclasses.dataclass(frozen=True)
class PanelLayout:
    """Host-side descriptor mapping a plan's X/B patterns to panel slots."""

    mb: int          # block rows
    lm: int
    ncc: int         # compressed non-empty block columns of X
    ln: int
    x_rows: np.ndarray       # int32[nnzbX]  block row of every X block
    x_cols: np.ndarray       # int32[nnzbX]  (== plan.colindx)
    b_rows: np.ndarray       # int32[nnzbB]  via the X block B scatters into
    b_cols: np.ndarray       # int32[nnzbB]
    mask: np.ndarray         # bool[mb, ncc]  X-pattern occupancy

    @classmethod
    def from_plan(cls, plan) -> "PanelLayout":
        x_rows = np.repeat(np.arange(plan.nrows, dtype=np.int32),
                           np.diff(plan.rowptr_x))
        x_cols = plan.colindx.cpu().numpy().astype(np.int32)
        sub = plan.subset.cpu().numpy().astype(np.int64)
        mask = np.zeros((plan.nrows, plan.ncols), dtype=bool)
        mask[x_rows, x_cols] = True
        return cls(mb=plan.nrows, lm=plan.lm, ncc=plan.ncols, ln=plan.ln,
                   x_rows=x_rows, x_cols=x_cols,
                   b_rows=x_rows[sub], b_cols=x_cols[sub], mask=mask)

    @property
    def nr(self) -> int:
        return self.mb * self.lm

    def pack_x(self, blocks: np.ndarray) -> np.ndarray:
        """[nnzbX, LM, LN] block list -> [mb*LM, ncc, LN] panel."""
        p = np.zeros((self.mb, self.lm, self.ncc, self.ln), blocks.dtype)
        p[self.x_rows, :, self.x_cols, :] = blocks
        return p.reshape(self.nr, self.ncc, self.ln)

    def pack_b(self, blocks: np.ndarray) -> np.ndarray:
        """[nnzbB, LM, LN] block list -> panel (zeros elsewhere)."""
        p = np.zeros((self.mb, self.lm, self.ncc, self.ln), blocks.dtype)
        p[self.b_rows, :, self.b_cols, :] = blocks
        return p.reshape(self.nr, self.ncc, self.ln)

    def unpack_x(self, panel: np.ndarray) -> np.ndarray:
        """[mb*LM, ncc, LN] panel -> [nnzbX, LM, LN] block list."""
        p = np.asarray(panel).reshape(self.mb, self.lm, self.ncc, self.ln)
        return p[self.x_rows, :, self.x_cols, :]

    def unit_b_blocks(self, dtype) -> np.ndarray:
        """Unit-matrix columns at B positions (set_unit_blocks semantics,
        tfqmrgpu_linalg.hxx:432-472): block[i, j % LM, j] = 1."""
        i = np.arange(self.lm)[:, None]
        j = np.arange(self.ln)[None, :]
        blk = ((j % self.lm) == i).astype(dtype)
        return np.broadcast_to(blk, (len(self.b_rows), self.lm, self.ln)).copy()

    def densify_a(self, plan, a_re: np.ndarray, a_im: np.ndarray):
        """Scatter BSR A blocks into dense [mb*LM, mb*LM] planes (once, at
        set_matrix time)."""
        n, lm = self.nr, self.lm
        dr = np.zeros((self.mb, lm, self.mb, lm), a_re.dtype)
        di = np.zeros((self.mb, lm, self.mb, lm), a_im.dtype)
        rows = np.repeat(np.arange(plan.nrows, dtype=np.int64),
                         np.diff(plan.rowptr_a))
        cols = plan.colind_a
        dr[rows, :, cols, :] = a_re
        di[rows, :, cols, :] = a_im
        return dr.reshape(n, n), di.reshape(n, n)


def apply_mask(v: Pair, mask4: torch.Tensor, mb: int, lm: int, ncc: int,
               ln: int) -> Pair:
    """Zero panel positions outside the X pattern; ``mask4`` is
    [mb, 1, ncc, 1] in the vector dtype."""
    def m(x):
        return (x.reshape(mb, lm, ncc, ln) * mask4).reshape(mb * lm, ncc, ln)
    return m(v[0]), m(v[1])


def make_panel_primitives(multiply_panel: Callable[[Pair], Pair]):
    """Panel-form ``core.TfqmrPrimitives``.

    ``multiply_panel`` maps an [NR, ncc, LN] pair to a masked [NR, ncc, LN]
    pair; ``add_rhs`` adds the B panel it is given, which lies in X's
    shape.  The reductions follow the JAX package's order of types: the sum
    over axis 0 in the data type, then a cast to float64 (its panel.py:140-148).
    """
    from ..core import TfqmrPrimitives

    f64 = torch.float64

    def dotp(x: Pair, y: Pair) -> Pair:
        zr = (x[0] * y[0] - x[1] * y[1]).sum(dim=0).to(f64)
        zi = (x[0] * y[1] + x[1] * y[0]).sum(dim=0).to(f64)
        return zr, zi

    def nrm2(x: Pair) -> torch.Tensor:
        return (x[0] * x[0] + x[1] * x[1]).sum(dim=0).to(f64)

    def axpy(y: Pair, x: Pair, a: Pair) -> Pair:
        ar, ai = a[0].to(y[0].dtype)[None], a[1].to(y[0].dtype)[None]
        return (ar * x[0] - ai * x[1] + y[0], ai * x[0] + ar * x[1] + y[1])

    def xpay(y: Pair, a: Pair, x: Pair) -> Pair:
        ar, ai = a[0].to(y[0].dtype)[None], a[1].to(y[0].dtype)[None]
        return (x[0] + ar * y[0] - ai * y[1], x[1] + ai * y[0] + ar * y[1])

    def add_rhs(v: Pair, b: Pair, scal: float) -> Pair:
        return v[0] + scal * b[0], v[1] + scal * b[1]

    return TfqmrPrimitives(multiply=multiply_panel, dotp=dotp, nrm2=nrm2,
                           axpy=axpy, xpay=xpay, add_rhs=add_rhs)


def _refuse_tf32():
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise TfqmrgpuError(
            encode_status(Status.PRECISION_MISSMATCH),
            "the dense engine's float32 product must be full FP32: turn "
            "off torch.backends.cuda.matmul.allow_tf32 and keep "
            "torch.get_float32_matmul_precision() at 'highest' (TF32 "
            "costs about 4 decimal digits)")


def dense_multiply(a_re: torch.Tensor, a_im: torch.Tensor,
                   mask4: torch.Tensor, mb: int, lm: int, ncc: int, ln: int):
    """The 'dense' engine's masked complex product: four real
    ``torch.matmul`` calls over the full depth NR = mb*LM, native float64
    for 'z' and full float32 for 'c' (a float32 call raises while TF32 is
    allowed).  The JAX package leaves this product to XLA outside any
    kernel, so it is no kernel of the port either.

    ``TFQ_Z_OZAKI=1`` sends float64 operands through the JAX package's
    Ozaki slice products instead (``_dense_multiply_oz``), and back to the
    plain product where the depth is too deep for them.  The port's default
    is '0', the JAX package's '1': the TPU has no float64 unit, the card
    has."""
    nr, c = mb * lm, ncc * ln
    f32 = a_re.dtype == torch.float32
    if f32:
        _refuse_tf32()
    if (a_re.dtype == torch.float64
            and os.environ.get("TFQ_Z_OZAKI", "0") != "0"):
        try:
            return _dense_multiply_oz(a_re, a_im, mask4, mb, lm, ncc, ln)
        except ValueError:
            pass    # contraction too deep for exact float32 products

    def multiply(x: Pair) -> Pair:
        if f32:
            _refuse_tf32()
        xr, xi = x[0].reshape(nr, c), x[1].reshape(nr, c)
        yr = a_re @ xr - a_im @ xi
        yi = a_re @ xi + a_im @ xr
        return apply_mask((yr.reshape(nr, ncc, ln), yi.reshape(nr, ncc, ln)),
                          mask4, mb, lm, ncc, ln)

    return multiply


def _dense_multiply_oz(a_re, a_im, mask4, mb, lm, ncc, ln, bits=53):
    """'z' dense product through the Ozaki scheme (``ops/ozaki.py``): the
    p(p+1)/2 exact slice products of each real product, combined in
    float64.  A's slices are built once here, X's every call.  Raises
    ValueError where NR is too deep for exact float32 slice products."""
    from . import ozaki

    nr, cc = mb * lm, ncc * ln
    # each product is combined in float64 on its own: slice_params_comp
    p, q = ozaki.slice_params_comp(nr, bits)
    ar_sl, sig_r = ozaki.slice_operand(a_re, axis=1, p=p, q=q,
                                       spare_binade=True)
    ai_sl, sig_i = ozaki.slice_operand(a_im, axis=1, p=p, q=q,
                                       spare_binade=True)
    s_idx, t_idx = ozaki.slice_pairs(p)

    def multiply(x: Pair) -> Pair:
        xr = x[0].reshape(nr, cc).to(torch.float64)
        xi = x[1].reshape(nr, cc).to(torch.float64)
        xr_sl, tau_r = ozaki.slice_operand(xr, axis=0, p=p, q=q,
                                           spare_binade=True)
        xi_sl, tau_i = ozaki.slice_operand(xi, axis=0, p=p, q=q,
                                           spare_binade=True)

        def prod(a_sl, x_sl):
            return ozaki.oz_products(a_sl, x_sl, s_idx, t_idx, p, q)

        yr = (prod(ar_sl, xr_sl) * (sig_r * tau_r)
              - prod(ai_sl, xi_sl) * (sig_i * tau_i))
        yi = (prod(ar_sl, xi_sl) * (sig_r * tau_i)
              + prod(ai_sl, xr_sl) * (sig_i * tau_r))
        return apply_mask((yr.reshape(nr, ncc, ln), yi.reshape(nr, ncc, ln)),
                          mask4, mb, lm, ncc, ln)

    return multiply


def flops_dense_multiply(mb: int, lm: int, ncc: int, ln: int) -> float:
    """Dense-engine flop count (includes the density waste)."""
    nr = mb * lm
    return 8.0 * nr * nr * ncc * ln

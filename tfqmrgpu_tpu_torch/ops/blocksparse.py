"""Block-sparse operator action  Y = A @ X  over a multiplication pair list.

This is the flop engine of the solver (~90% of the work).  The contraction
is

    Y[iY] = sum_{p in [starts[iY], starts[iY+1])}  A[pairs[p,0]] @ X[pairs[p,1]]

with complex LM x LM blocks of A and LM x LN blocks of X and Y (reference:
gemmNxNf, tfqmrgpu_blockmult.hxx:10-93; the CPU oracle in
tfqmrgpu_blocksparse.hxx:142-196).

``spmm_pairs`` is the plain PyTorch version: gather both operand blocks per
pair, four real batched products, then ``index_add_`` into the Y blocks.
It serves CPU tensors, the tests, and the comparison with the hand-written
kernel in ``ops/pairpanel.py``.  ``spmm_pairs_oz`` is the JAX package's
float64-quality product from bf16 slices (``ops/ozaki.py``), the
``TFQ_XLA_OZ=1`` opt-in of the block-list engine.  On a CUDA tensor its ``index_add_`` uses
atomics, so its sum order (not its value beyond rounding) can change
between runs; the solver's main path uses the kernel instead.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

Pair = tuple


def spmm_pairs(a: Pair, x: Pair, pair_a: torch.Tensor, pair_x: torch.Tensor,
               pair_y: torch.Tensor, nnzb_y: int) -> Pair:
    """Plain pair-list SpMM: ``a`` planes [nnzbA, LM, LM], ``x`` planes
    [nnzbX, LM, LN], int tensors [nPairs] (``pair_y`` ascending)."""
    ar, ai = a[0][pair_a], a[1][pair_a]
    xr, xi = x[0][pair_x], x[1][pair_x]
    pr = torch.bmm(ar, xr) - torch.bmm(ai, xi)
    pi = torch.bmm(ar, xi) + torch.bmm(ai, xr)
    shape = (nnzb_y,) + tuple(pr.shape[1:])
    yr = pr.new_zeros(shape).index_add_(0, pair_y, pr)
    yi = pi.new_zeros(shape).index_add_(0, pair_y, pi)
    return yr, yi


def flops_spmm(n_pairs: int, lm: int, ln: int) -> float:
    """Reference flop model: nPairs * 8 * LM^2 * LN
    (tfqmrgpu_blocksparse.hxx:198, bench_tfqmrgpu.cu:335)."""
    return n_pairs * 8.0 * lm * lm * ln


def spmm_pairs_oz(a_sl: Pair, a_scale: Pair, x: Pair, pair_a: torch.Tensor,
                  pair_x: torch.Tensor, pair_y: torch.Tensor, nnzb_y: int,
                  p: int, q: int) -> Pair:
    """float64-quality pair-list SpMM through exact bf16 slice products
    (the JAX package's ``spmm_pairs_oz``; ``ops/ozaki.py``).

    a_sl:    (re, im) bf16 [p, nnzbA, LM, LM] A slices, made once per A.
    a_scale: (re, im) float64 [nnzbA, LM, 1] power-of-two block-row scales.
    x:       (re, im) float64 [nnzbX, LM, LN]; sliced here, every call.

    Each kept slice product (``ozaki.slice_pairs``) is a float32
    ``torch.bmm`` over all pairs, exact, added in float64 in the JAX
    package's order; the descale and the complex assembly run in float64,
    then ``index_add_`` into the Y blocks."""
    from . import ozaki
    from .panel import _refuse_tf32

    _refuse_tf32()
    xr_sl, taur = ozaki.slice_operand(x[0], axis=1, p=p, q=q)
    xi_sl, taui = ozaki.slice_operand(x[1], axis=1, p=p, q=q)
    ar, ai = a_sl[0][:, pair_a], a_sl[1][:, pair_a]   # [p, nPairs, LM, LM]
    xr, xi = xr_sl[:, pair_x], xi_sl[:, pair_x]       # [p, nPairs, LM, LN]

    def dot(u, v):
        return torch.bmm(u.to(torch.float32),
                         v.to(torch.float32)).to(torch.float64)

    rr = ii = ri = ir = 0.0
    for s, t in zip(*(v.tolist() for v in ozaki.slice_pairs(p))):
        rr = rr + dot(ar[s], xr[t])
        ii = ii + dot(ai[s], xi[t])
        ri = ri + dot(ar[s], xi[t])
        ir = ir + dot(ai[s], xr[t])
    sr, si = a_scale[0][pair_a], a_scale[1][pair_a]   # [nPairs, LM, 1]
    tr, ti = taur[pair_x], taui[pair_x]               # [nPairs, 1, LN]
    pr = rr * (sr * tr) - ii * (si * ti)
    pi = ri * (sr * ti) + ir * (si * tr)
    shape = (nnzb_y,) + tuple(pr.shape[1:])
    yr = pr.new_zeros(shape).index_add_(0, pair_y, pr)
    yi = pi.new_zeros(shape).index_add_(0, pair_y, pi)
    return yr, yi


@dataclasses.dataclass
class BlockSparseAction:
    """The block-list operator action (the 'xla' engine): explicit
    block-sparse A and the plan's pair tables, callable as
    ``action(x) -> y`` (reference: blocksparse_action_t,
    tfqmrgpu_blocksparse.hxx:14-203).

    With ``TFQ_XLA_OZ=1`` float64 operands run the JAX package's Ozaki
    product (``spmm_pairs_oz``) over A slices made once here.  The port's
    default is '0', native float64, where the JAX package's is '1': the TPU
    has no float64 unit, the card has."""

    a_re: torch.Tensor          # [nnzbA, LM, LM]
    a_im: torch.Tensor
    pair_a: torch.Tensor        # int32[nPairs]
    pair_x: torch.Tensor        # int32[nPairs]
    pair_y: torch.Tensor        # int64[nPairs], ascending
    nnzb_y: int
    # Ozaki A slices (float64 A under TFQ_XLA_OZ=1)
    oz_a_sl: Optional[tuple] = None      # (re, im) bf16 [p, nnzbA, LM, LM]
    oz_a_scale: Optional[tuple] = None   # (re, im) float64 [nnzbA, LM, 1]
    oz_pq: Optional[tuple] = None        # (p, q)

    @classmethod
    def from_plan(cls, plan, a_re: torch.Tensor,
                  a_im: torch.Tensor) -> "BlockSparseAction":
        kw = {}
        if (a_re.dtype == torch.float64
                and os.environ.get("TFQ_XLA_OZ", "0") != "0"):
            from . import ozaki

            p, q = ozaki.slice_params(int(a_re.shape[1]))
            ar_sl, sig_r = ozaki.slice_operand(a_re, axis=2, p=p, q=q)
            ai_sl, sig_i = ozaki.slice_operand(a_im, axis=2, p=p, q=q)
            kw = dict(oz_a_sl=(ar_sl, ai_sl), oz_a_scale=(sig_r, sig_i),
                      oz_pq=(p, q))
        return cls(a_re=a_re, a_im=a_im, pair_a=plan.pairs[:, 0],
                   pair_x=plan.pairs[:, 1], pair_y=plan.pair_y(),
                   nnzb_y=plan.nnzb_x, **kw)

    def multiply(self, x: Pair) -> Pair:
        if self.oz_pq is not None and x[0].dtype == torch.float64:
            return spmm_pairs_oz(self.oz_a_sl, self.oz_a_scale, x,
                                 self.pair_a, self.pair_x, self.pair_y,
                                 self.nnzb_y, *self.oz_pq)
        return spmm_pairs((self.a_re, self.a_im), x, self.pair_a,
                          self.pair_x, self.pair_y, self.nnzb_y)

    __call__ = multiply

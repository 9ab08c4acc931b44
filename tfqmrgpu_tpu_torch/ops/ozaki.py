"""Ozaki-scheme float64-quality products from exact bf16 slice products.

Counterpart of ``tfqmrgpu_tpu/ops/ozaki.py``, whose function names and
arithmetic it keeps.  The TPU has no float64 unit, so the JAX package
reaches float64 quality from bf16 products by exponent-blocked integer
slicing (the Ozaki scheme):

    A[i, :] = sigma_i * sum_s S_s[i, :]        |S_s| = int * 2^{-(s+1)q}
    X[:, j] = tau_j  * sum_t T_t[:, j]         with int in [-2^q, 2^q]

Every slice value is an integer times a power of two with at most q+1
significand bits, so it is exact in bfloat16; every cross product S_s @ T_t
of depth K is exact in float32 while K * 2^{2q} <= 2^24; only the products
with s + t < p are kept, and the combine with the power-of-two scales runs
in float64.

The H100 has float64 itself: the port's 'z' solves run native float64 (K1
on the FP64 tensor cores, ``torch.matmul`` in 'dense'), and the two callers
of this module are opt-ins that reproduce the JAX package's 'z' arithmetic,
``TFQ_XLA_OZ=1`` for the block-list engine (``blocksparse.spmm_pairs_oz``)
and ``TFQ_Z_OZAKI=1`` for the dense engine (``panel._dense_multiply_oz``).
The JAX package computes the slice products in XLA, outside any Pallas
kernel (its ozaki.py:173-180), so the port takes them with float32
``torch.matmul`` calls of the slice planes; TF32 must be off (a float32
call raises while it is allowed), since every product and partial sum has
to be exact in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .panel import _refuse_tf32

DBL_MIN = float(np.finfo(np.float64).tiny)      # the least normal float64


def slice_params(k: int, bits: int = 53,
                 diag_sum: bool = False) -> tuple[int, int]:
    """(p, q) for contraction depth ``k``: q bits a slice so that
    K*2^(2q) <= 2^24 (exact float32 sums), p slices so that the truncation
    floor 2^(-p*q) covers ``bits`` significand bits.  ``diag_sum`` also
    keeps the float32 sum of one diagonal's <= p products exact
    (p * K * 2^(2q) <= 2^24)."""
    if k < 1:
        raise ValueError(f"contraction depth must be >= 1, got {k}")
    # q <= 8: slice integers (with the round-half carry to 2^q) must fit
    # bf16's 8 significand bits
    for q in range(8, 1, -1):
        p = math.ceil(bits / q) + (1 if bits % q == 0 else 0)
        terms = p if diag_sum else 1
        if terms * k * 4 ** q <= 2 ** 24:
            return p, q
    raise ValueError(
        f"contraction depth {k} too deep for exact f32 accumulation; "
        f"chunk the contraction and combine in f64")


def slice_params_comp(k: int, bits: int = 53) -> tuple[int, int]:
    """(p, q) when both operands are scaled into |.| <= 0.5 (one spare
    binade each) and every k-deep product is combined in float64 on its
    own: slice integers are capped at 2^{q-1} (+1 for the stored-value
    residuals of the JAX package's slicer), so the condition is
    k * (2^{q-1} + 1)^2 <= 2^24."""
    if k < 1:
        raise ValueError(f"contraction depth must be >= 1, got {k}")
    for q in range(8, 1, -1):
        p = math.ceil(bits / q) + (1 if bits % q == 0 else 0)
        if k * (2 ** (q - 1) + 1) ** 2 <= 2 ** 24:
            return p, q
    raise ValueError(
        f"contraction depth {k} too deep for exact f32 slice products; "
        f"chunk the contraction and combine in f64")


def slice_pairs(p: int) -> tuple[np.ndarray, np.ndarray]:
    """All (s, t) slice-index pairs with s + t <= p - 1, the products above
    the truncation floor, ordered by diagonal (descending magnitude)."""
    st = [(s, d - s) for d in range(p) for s in range(d + 1)]
    s, t = np.array(st, dtype=np.int32).T.reshape(2, -1)
    return s, t


def _pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """The float32 power of two 2^e (e in [-126, 127]) from its exponent
    field, as float64."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32).to(
        torch.float64)


def pow2_scale(amax: torch.Tensor) -> torch.Tensor:
    """A power of two >= ``amax`` (float64), taken from the float32 bit
    pattern of amax as the JAX package takes it (one binade above the least
    such power where the float32 cast rounds up), zeros mapped to 1 (and
    float64 subnormals, which XLA reads as zero).  One pre-scale tier of
    2^±200 extends the exact range to |log2 amax| <= ~326; beyond it the
    scale saturates at the range edge."""
    amax = torch.as_tensor(amax, dtype=torch.float64)
    a64 = torch.where(amax >= DBL_MIN, amax, torch.ones_like(amax))
    big = a64 > 2.0 ** 126
    tiny = a64 < 2.0 ** -125
    one = torch.ones_like(a64)
    adj = torch.where(big, one * 2.0 ** -200,
                      torch.where(tiny, one * 2.0 ** 200, one))
    a = (a64 * adj).to(torch.float32)          # power-of-two product: exact
    bits = a.view(torch.int32)                 # a >= 0: the sign bit is 0
    e = ((bits >> 23) & 0xFF) - 126            # floor(log2) + 1
    e = e + big.to(torch.int32) * 200 - tiny.to(torch.int32) * 200
    e1 = e.clamp(-126, 127)
    e2 = (e - e1).clamp(-126, 127)
    return _pow2_f32(e1) * _pow2_f32(e2) * _pow2_f32(
        (e - e1 - e2).clamp(-126, 127))


def slice_operand(v: torch.Tensor, axis: int, p: int, q: int,
                  spare_binade: bool = False) -> tuple:
    """Exponent-blocked slicing of a float64 tensor along its
    non-contraction ``axis``: (slices bfloat16 [p, *v.shape], scale float64
    with ``axis`` reduced to 1) such that v == scale * sum_s slices[s] up to
    the 2^{-p*q} truncation.  The max-abs over ``axis`` sets the shared
    power-of-two scale; ``spare_binade`` doubles it (|v/scale| <= 0.5)."""
    v = torch.as_tensor(v).to(torch.float64)
    scale = pow2_scale(v.abs().amax(dim=axis, keepdim=True))
    if spare_binade:
        scale = scale * 2.0
    r = v / scale                                    # |r| <= 1, exact
    out = []
    for s in range(p):
        step = 2.0 ** ((s + 1) * q)
        sl = torch.round(r * step) / step            # int * 2^{-(s+1)q}
        r = r - sl                                   # exact: shared ulp grid
        out.append(sl.to(torch.bfloat16))            # exact: <= q+1 bits
    return torch.stack(out), scale


def oz_products(a_sl: torch.Tensor, x_sl: torch.Tensor, s_idx, t_idx,
                p: int, q: int) -> torch.Tensor:
    """The kept slice products a_sl[s] @ x_sl[t] (bf16 [p, M, K] and
    [p, K, N]) as float32 ``torch.matmul`` calls, each exact, summed in
    float64 in the order of ``slice_pairs``.  (``p`` and ``q`` are the JAX
    signature's; the slices carry them.)"""
    del p, q
    _refuse_tf32()
    y = None
    for s, t in zip(np.asarray(s_idx).tolist(), np.asarray(t_idx).tolist()):
        prod = torch.matmul(a_sl[s].to(torch.float32),
                            x_sl[t].to(torch.float32)).to(torch.float64)
        y = prod if y is None else y + prod
    return y


def matmul_oz(a: torch.Tensor, x: torch.Tensor, bits: int = 53):
    """float64-quality ``a @ x`` through exact bf16 slice products.

    a: [M, K] float64, x: [K, N] float64 -> [M, N] float64, with an error of
    about K * 2^{-bits} relative to |a_row|_inf * |x_col|_inf.  Raises
    TypeError for operands that are not float64."""
    a, x = torch.as_tensor(a), torch.as_tensor(x)
    if a.dtype != torch.float64 or x.dtype != torch.float64:
        raise TypeError(f"matmul_oz needs float64 operands, got {a.dtype} "
                        f"and {x.dtype}")
    k = a.shape[-1]
    if x.shape[0] != k:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ "
                         f"{tuple(x.shape)}")
    # every product is combined in float64 on its own: the dual spare
    # binade sizing of slice_params_comp
    p, q = slice_params_comp(k, bits)
    a_sl, sig = slice_operand(a, axis=1, p=p, q=q, spare_binade=True)
    x_sl, tau = slice_operand(x, axis=0, p=p, q=q, spare_binade=True)
    s_idx, t_idx = slice_pairs(p)
    y = oz_products(a_sl, x_sl, s_idx, t_idx, p, q)
    return y * sig * tau                             # powers of two: exact


def matmul_oz_complex(a_re, a_im, x_re, x_im, bits: int = 53):
    """Complex float64-quality product from four real Ozaki products, the
    complex assembly in float64: (re, im)."""
    rr = matmul_oz(a_re, x_re, bits)
    ii = matmul_oz(a_im, x_im, bits)
    ri = matmul_oz(a_re, x_im, bits)
    ir = matmul_oz(a_im, x_re, bits)
    return rr - ii, ri + ir

"""The yardstick's arithmetic: what one multiply Y = A @ X over X's pattern
needs, and the card's peaks.

Operations: 8 LM^2 LN a pair in complex arithmetic (the reference's count,
bench_tfqmrgpu.cu:335), the pairs counted by the reference's own table from
the three patterns.  Bytes: A, X and Y each moved once in the
configuration's precision, whatever an engine pads or stages.  The bound
of a multiply is the larger of operations over the peak rate and bytes
over the memory rate.
"""

from __future__ import annotations

from .reference.operator import count_pairs

# NVIDIA's data sheet, H100 SXM, dense rates: FP64 on the tensor cores and
# the HBM3 rate, at the full power limit of 700 W
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp64_flops": 67e12, "hbm_bytes": 3.35e12}}
COMPLEX_BYTES = {"z": 16}


def multiply(problem, precision: str) -> dict:
    """{'pairs', 'flops', 'bytes'} of one multiply of ``problem``."""
    pairs = count_pairs(problem.a_rowptr, problem.a_colind, problem.x_rowptr,
                        problem.x_colind, problem.ncols)
    lm, ln = problem.lm, problem.ln
    nnzb = problem.nnzb
    word = COMPLEX_BYTES[precision]
    return {"pairs": pairs, "flops": 8.0 * lm * lm * ln * pairs,
            "bytes": float(word * (nnzb["A"] * lm * lm
                                   + 2 * nnzb["X"] * lm * ln))}


def bound_seconds(work: dict, kind: str) -> float:
    """The least time of ``work`` on the card ``kind``; KeyError for a card
    the table does not hold."""
    peak = PEAKS[kind]
    return max(work["flops"] / peak["fp64_flops"],
               work["bytes"] / peak["hbm_bytes"])

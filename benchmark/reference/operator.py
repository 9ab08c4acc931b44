"""The plain block-sparse product of the reference: Y = A @ X restricted to
X's pattern, as the tfQMR solve of the reference library sees it.

For every X block y = (row r, column c) the pairs are the A blocks (r, k)
whose X block (k, c) exists.  The table lists them per y, padded with a
zero A block, so the product is ``width`` batched products of gathered
blocks, summed in a fixed order: no atomics, the same bits every call.
Plain torch and numpy; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def pair_table(a_rowptr, a_colind, x_rowptr, x_colind, ncols: int) -> tuple:
    """(a_idx, x_idx, valid): int64 [nnzbX, width] tables of each X block's
    pairs, and which entries are pairs.  Padding points at A block nnzbA
    and X block 0."""
    nrows = len(a_rowptr) - 1
    nnzb_a = len(a_colind)
    x_row = np.repeat(np.arange(nrows), np.diff(x_rowptr))
    x_col = np.asarray(x_colind, np.int64)
    x_at = -np.ones((nrows, ncols), np.int64)
    x_at[x_row, x_col] = np.arange(x_col.shape[0])
    deg = np.diff(a_rowptr)
    width = max(int(deg.max()) if nrows else 0, 1)
    slot = np.arange(width)[None, :]
    a_pad = np.where(slot < deg[:, None], a_rowptr[:-1, None] + slot, -1)
    a_idx = a_pad[x_row]                                   # [nnzbX, width]
    k = np.where(a_idx >= 0, np.asarray(a_colind)[np.maximum(a_idx, 0)], 0)
    x_idx = x_at[k, x_col[:, None]]
    valid = (a_idx >= 0) & (x_idx >= 0)
    return (np.where(valid, a_idx, nnzb_a), np.where(valid, x_idx, 0), valid)


def count_pairs(a_rowptr, a_colind, x_rowptr, x_colind, ncols: int) -> int:
    return int(pair_table(a_rowptr, a_colind, x_rowptr, x_colind,
                          ncols)[2].sum())


class Operator:
    """A_k restricted to X's pattern, on ``device`` in ``dtype``
    (complex128, or complex64 for the control)."""

    def __init__(self, problem, a: np.ndarray, device, dtype=torch.complex128):
        a_idx, x_idx, _ = pair_table(problem.a_rowptr, problem.a_colind,
                                     problem.x_rowptr, problem.x_colind,
                                     problem.ncols)
        self.device, self.dtype = device, dtype
        self.a_idx = torch.from_numpy(a_idx).to(device)
        self.x_idx = torch.from_numpy(x_idx).to(device)
        blocks = torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
        self.a = torch.cat([blocks, blocks.new_zeros((1,) + blocks.shape[1:])])
        self.nnzb_x = int(a_idx.shape[0])
        col = np.asarray(problem.x_colind, np.int64)
        self.col = torch.from_numpy(col).to(device)
        self.ncols = problem.ncols
        # each column's X blocks, padded with block nnzbX (a zero row)
        order = np.argsort(col, kind="stable")
        counts = np.bincount(col, minlength=self.ncols)
        slot = np.arange(col.shape[0]) - np.repeat(np.cumsum(counts) - counts,
                                                   counts)
        table = np.full((self.ncols, max(int(counts.max()), 1)),
                        self.nnzb_x, np.int64)
        table[col[order], slot] = order
        self.col_table = torch.from_numpy(table).to(device)
        # B scattered into X's pattern
        x_row = np.repeat(np.arange(problem.nrows), np.diff(problem.x_rowptr))
        b_row = np.repeat(np.arange(problem.nrows), np.diff(problem.b_rowptr))
        key = {(int(r), int(c)): i for i, (r, c) in enumerate(zip(x_row, col))}
        self.b_slot = np.array([key[(int(r), int(c))] for r, c in
                                zip(b_row, problem.b_colind)], np.int64)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for j in range(self.a_idx.shape[1]):
            y += self.a[self.a_idx[:, j]] @ x[self.x_idx[:, j]]
        return y

    def rhs(self, b_data: np.ndarray) -> torch.Tensor:
        """B's blocks in X's pattern, [nnzbX, LM, LN] in ``dtype``."""
        lm, ln = b_data.shape[1:]
        b = np.zeros((self.nnzb_x, lm, ln), np.complex128)
        b[self.b_slot] = b_data
        return torch.from_numpy(b).to(self.device, self.dtype)

    def column_sum(self, p: torch.Tensor) -> torch.Tensor:
        """[nnzbX, LN] partials -> [ncols, LN] column sums, in a fixed
        order, in float64 (complex128 for complex partials)."""
        p = p.to(torch.complex128 if p.is_complex() else torch.float64)
        padded = torch.cat([p, p.new_zeros((1, p.shape[1]))])
        return padded[self.col_table].sum(dim=1)

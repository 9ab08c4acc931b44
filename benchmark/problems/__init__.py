"""The inputs of a configuration: block patterns and operators.

A configuration's file names its problem kind (``"problem": "fd"``), and
``build`` loads ``problems/<kind>.py`` by that name, so a configuration of
a kind that is here is data alone.  Each kind's ``build(config, seed,
device)`` returns a ``Problem``: the patterns of A, X and B, B's data, and
the operator that the traffic shifts along its contour.  Random numbers
come from ``torch.Generator`` on ``device`` in a few large calls, seeded
from ``--seed``; the same seed on the same kind of device gives the same
inputs.  The benchmark hands these arrays to the program and to the
reference alike.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import numpy as np


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of ``seed`` (any whole number
    >= 0, larger than 32 bits included)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *tag.encode()]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _csr(rows: list) -> tuple:
    rowptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    colind = np.array([c for r in rows for c in r], dtype=np.int64)
    return rowptr.astype(np.int64), colind


@dataclasses.dataclass
class Problem:
    """Patterns (CSR over block rows) and data of A @ X = B."""

    nrows: int
    ncols: int
    lm: int
    ln: int
    a_rowptr: np.ndarray
    a_colind: np.ndarray
    x_rowptr: np.ndarray
    x_colind: np.ndarray
    b_rowptr: np.ndarray
    b_colind: np.ndarray
    b_data: Optional[np.ndarray] = None     # complex128 [nnzbB, LM, LN]
    # the operator before the contour's shift, complex128 [nnzbA, LM, LM]
    operator: Optional[np.ndarray] = None

    @classmethod
    def from_columns(cls, nrows: int, ncols: int, a_cols: list, x_cols: list,
                     b_cols: list, lm: int, ln: int) -> "Problem":
        return cls(nrows, ncols, lm, ln, *_csr(a_cols), *_csr(x_cols),
                   *_csr(b_cols))

    @property
    def diag(self) -> np.ndarray:
        """The index of each row's diagonal block of A."""
        rows = np.repeat(np.arange(self.nrows), np.diff(self.a_rowptr))
        hit = np.flatnonzero(self.a_colind == rows)
        if hit.shape[0] != self.nrows:
            raise ValueError("A lacks a diagonal block in some row")
        return hit

    @property
    def nnzb(self) -> dict:
        return {"A": int(self.a_colind.shape[0]),
                "X": int(self.x_colind.shape[0]),
                "B": int(self.b_colind.shape[0])}


def build(config: dict, seed: int, device) -> Problem:
    """The problem of ``config``, by its kind's module."""
    kind = importlib.import_module(f"{__name__}.{config['problem']}")
    return kind.build(config, seed, device)

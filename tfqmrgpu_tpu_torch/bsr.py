"""Host-side BSR (Block-compressed Sparse Row) container.

Reference semantics: bsr.hxx:10-24 and the BSR traversal contract of
tfqmrgpu.h:119-133.  Patterns and block data stay on the host as numpy
arrays; the solver splits the data into real and imaginary planes and moves
them to its device (see ``ops/layout.py`` and ``solver.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .errors import Status, TfqmrgpuError, encode_status


@dataclasses.dataclass
class Bsr:
    """A block-sparse pattern plus optional complex block data.

    Attributes:
      nrows:   number of block rows.
      ncols:   number of block columns (logical; A must be square).
      rowptr:  int32[nrows+1], rowptr[0] == 0, rowptr[nrows] == nnzb.
      colind:  int32[nnzb], column index of each nonzero block.
      data:    optional complex ndarray [nnzb, slow, fast].
      name:    'A', 'B' or 'X' for diagnostics.
    """

    nrows: int
    ncols: int
    rowptr: np.ndarray
    colind: np.ndarray
    data: Optional[np.ndarray] = None
    name: str = "?"

    def __post_init__(self):
        self.rowptr = np.asarray(self.rowptr, dtype=np.int32)
        self.colind = np.asarray(self.colind, dtype=np.int32)
        if self.data is not None:
            self.data = np.asarray(self.data)

    @property
    def nnzb(self) -> int:
        return int(self.colind.shape[0])

    @property
    def slow_block_dim(self) -> int:
        return int(self.data.shape[1]) if self.data is not None else 0

    @property
    def fast_block_dim(self) -> int:
        return int(self.data.shape[2]) if self.data is not None else 0

    def validate(self, line: int = 0):
        """Sanity checks mirroring createPlan's (tfqmrgpu.cu:166-172)."""
        def fail(detail):
            raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, line),
                                f"{self.name}: {detail}")

        if self.nrows < 1:
            fail("nrows < 1")
        if self.rowptr.shape[0] != self.nrows + 1:
            fail("rowptr has wrong length")
        if int(self.rowptr[-1] - self.rowptr[0]) != self.nnzb:
            fail("rowptr range != nnzb")
        if np.any(np.diff(self.rowptr) < 0):
            fail("rowptr not monotone")
        if self.nnzb and self.colind.min() < 0:
            fail("negative column index")
        if self.nnzb > 1:
            # a duplicate column in a row would make the pair list sum a
            # block twice while a dense assembly overwrites it
            row = self.row_of().astype(np.int64)
            key = row * (int(self.colind.max(initial=0)) + 1) \
                + self.colind.astype(np.int64)
            if np.unique(key).shape[0] != self.nnzb:
                fail("duplicate column index within a row")

    def row_of(self) -> np.ndarray:
        """int32[nnzb]: block row index of every nonzero block."""
        return np.repeat(np.arange(self.nrows, dtype=np.int32),
                         np.diff(self.rowptr))

    # ------------------------------------------------------ scipy interop

    @classmethod
    def from_scipy_bsr(cls, m, name: str = "?") -> "Bsr":
        """Build from a ``scipy.sparse.bsr_matrix`` / ``bsr_array`` (or any
        scipy sparse matrix with ``tobsr``)."""
        m = m.tobsr() if hasattr(m, "tobsr") else m
        br, bc = m.blocksize
        return cls(nrows=m.shape[0] // br, ncols=m.shape[1] // bc,
                   rowptr=np.asarray(m.indptr), colind=np.asarray(m.indices),
                   data=np.asarray(m.data), name=name)

    def to_scipy_bsr(self):
        """The matrix as a ``scipy.sparse.bsr_matrix`` (needs data)."""
        from scipy.sparse import bsr_matrix

        if self.data is None:
            raise ValueError("no block data attached")
        br, bc = self.data.shape[1], self.data.shape[2]
        return bsr_matrix((self.data, self.colind, self.rowptr),
                          shape=(self.nrows * br, self.ncols * bc))

    # ------------------------------------------------------------- helpers

    def with_data(self, data: np.ndarray) -> "Bsr":
        data = np.asarray(data)
        if data.shape[0] != self.nnzb:
            raise ValueError(f"data has {data.shape[0]} blocks, "
                             f"pattern has {self.nnzb}")
        return dataclasses.replace(self, data=data)

    def pattern_key(self) -> bytes:
        """SHA-256 of the sparsity pattern (the plan cache's key): the same
        bytes as the JAX package's ``Bsr.pattern_key`` for the same
        pattern."""
        import hashlib

        h = hashlib.sha256()
        h.update(np.int64([self.nrows, self.ncols, self.nnzb]).tobytes())
        h.update(self.rowptr.tobytes())
        h.update(self.colind.tobytes())
        return h.digest()


# the reference's name for the container ("BlockSparseMatrix" XML tag)
BlockSparseMatrix = Bsr


def make_bsr(nrows: int, ncols: int, rowptr, colind, data=None,
             name: str = "?") -> Bsr:
    """A validated ``Bsr``."""
    b = Bsr(nrows=nrows, ncols=ncols, rowptr=np.asarray(rowptr),
            colind=np.asarray(colind), data=data, name=name)
    b.validate()
    return b

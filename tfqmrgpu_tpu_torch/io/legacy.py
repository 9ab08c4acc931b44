"""Legacy Fortran-dump problem format.

Keyword-dispatched text format produced by Fortran codes and consumed by the
reference's example reader (reference: tfqmrgpu_example_reader.hxx:43-218):

    tolerance <tol>
    nRHSs <block_size>          (the SLOW block dim of X/B; naming is historic)
    nCols <n>                   (number of block columns of X/B)
    bsr_A%nCols <n>
    sizebsr_A%RowStart <nRows+1>
      ... nRows+1 integers, 1-based ...
    sizebsr_A%ColIndex <nnzb>
      ... nnzb integers, 1-based ...
    shapemat_A <fast> <slow> <nnzb>
      ... nnzb*slow*fast*2 reals, column-major within each block,
          RIRIRIRI-interleaved ...
    (same for B and X)

Semantics reproduced from the reference:
  * indices are 1-based (converted on read);
  * when B has fewer block rows than X, empty rows are appended
    (tfqmrgpu_example_reader.hxx:193-213);
  * per-operator nonzero statistics are printed at echo > 0
    (tfqmrgpu_example_reader.hxx:148-175).

The module is the JAX package's ``tfqmrgpu_tpu/io/legacy.py`` over this
package's ``Bsr``: the writer gives the same bytes, the reader the same
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..bsr import Bsr


@dataclasses.dataclass
class LegacyProblem:
    a: Bsr
    b: Bsr
    x: Bsr
    tolerance: float


def _print_stats(op: Bsr):
    nz_rows = np.diff(op.rowptr)
    nzpc = np.bincount(op.colind, minlength=op.ncols)
    for arr, total, what in ((nz_rows, op.nrows, "rows"),
                             (nzpc, op.ncols, "columns")):
        occ = arr[arr > 0]
        avg = occ.mean() if occ.size else 0.0
        dev = occ.std() if occ.size else -1.0
        print(f"# non-zeros {avg} +/- {dev} in {occ.size} of {total} {what}")


def read_legacy(path: str, echo: int = 0) -> LegacyProblem:
    """Parse a legacy problem dump into (A, B, X) + tolerance."""
    with open(path) as fh:
        tokens = fh.read().split()

    ops = {name: dict(ncols=0, rowptr=None, colind=None, data=None,
                      fast=0, slow=0) for name in "ABX"}
    tolerance = 0.0
    block_size = 0
    ncols_global = 0

    i = 0
    n = len(tokens)
    while i < n:
        kw = tokens[i]
        i += 1

        def take(count):
            nonlocal i
            vals = tokens[i:i + count]
            i += count
            return vals

        if kw == "tolerance":
            tolerance = float(take(1)[0])
        elif kw == "nRHSs":
            block_size = int(take(1)[0])
        elif kw == "nCols":
            ncols_global = int(take(1)[0])
        elif kw.startswith("bsr_") and kw.endswith("%nCols"):
            ops[kw[4]]["ncols"] = int(take(1)[0])
        elif kw.startswith("sizebsr_") and kw.endswith("%RowStart"):
            cnt = int(take(1)[0])
            ops[kw[8]]["rowptr"] = (
                np.array(take(cnt), dtype=np.int64) - 1)  # Fortran -> C
        elif kw.startswith("sizebsr_") and kw.endswith("%ColIndex"):
            cnt = int(take(1)[0])
            ops[kw[8]]["colind"] = (
                np.array(take(cnt), dtype=np.int64) - 1)
        elif kw.startswith("shapemat_"):
            name = kw[9]
            fast, slow, nnzb = (int(v) for v in take(3))
            vals = np.array(take(nnzb * slow * fast * 2), dtype=np.float64)
            ops[name]["fast"], ops[name]["slow"] = fast, slow
            # column-major within each block, RIRI interleave ->
            # [nnzb, slow, fast] complex
            b = vals.reshape(nnzb, slow, fast, 2)
            ops[name]["data"] = b[..., 0] + 1j * b[..., 1]
        else:
            print(f"# keyword {kw} unknown!")

    out = {}
    for name in "ABX":
        d = ops[name]
        if d["rowptr"] is None:
            raise ValueError(f"operator {name} missing from {path}")
        out[name] = Bsr(nrows=int(d["rowptr"].shape[0] - 1),
                        ncols=int(d["ncols"]),
                        rowptr=d["rowptr"], colind=d["colind"],
                        data=d["data"], name=name)
        if echo > 0:
            print(f"# stats for the {out[name].nnzb} non-zero entries "
                  f"of {name}")
            _print_stats(out[name])

    a, b, x = out["A"], out["B"], out["X"]
    if ncols_global:
        assert b.ncols == ncols_global and x.ncols == ncols_global
    if block_size:
        assert x.data is None or x.data.shape[1] == block_size

    # pad missing empty rows of B (tfqmrgpu_example_reader.hxx:193-213)
    if b.nrows < x.nrows:
        if echo > 0:
            print(f"# add {x.nrows - b.nrows} empty rows to B")
        pad = np.full(x.nrows - b.nrows, b.rowptr[-1], dtype=b.rowptr.dtype)
        b = Bsr(nrows=x.nrows, ncols=b.ncols,
                rowptr=np.concatenate([b.rowptr, pad]),
                colind=b.colind, data=b.data, name="B")

    return LegacyProblem(a=a, b=b, x=x, tolerance=tolerance)


def write_legacy(path: str, a: Bsr, b: Bsr, x: Bsr,
                 tolerance: float = 1e-9):
    """Write (A, B, X) in the legacy dump format (1-based indices)."""
    def dump_op(fh, op: Bsr, with_data: bool):
        name = op.name if op.name in "ABX" else "?"
        fh.write(f"bsr_{name}%nCols {op.ncols}\n")
        fh.write(f"sizebsr_{name}%RowStart {op.nrows + 1}\n")
        fh.write(" ".join(str(int(v) + 1) for v in op.rowptr) + "\n")
        fh.write(f"sizebsr_{name}%ColIndex {op.nnzb}\n")
        fh.write(" ".join(str(int(v) + 1) for v in op.colind) + "\n")
        if with_data and op.data is not None:
            slow, fast = op.data.shape[1], op.data.shape[2]
            fh.write(f"shapemat_{name} {fast} {slow} {op.nnzb}\n")
            flat = np.stack([op.data.real, op.data.imag],
                            axis=-1).reshape(-1)
            fh.write("\n".join(
                " ".join(f"{v:.17g}" for v in flat[k:k + 8])
                for k in range(0, flat.size, 8)) + "\n")

    with open(path, "w") as fh:
        fh.write(f"tolerance {tolerance:g}\n")
        slow = x.data.shape[1] if x.data is not None else (
            b.data.shape[1] if b.data is not None else 0)
        if slow:
            fh.write(f"nRHSs {slow}\n")
        fh.write(f"nCols {x.ncols}\n")
        dump_op(fh, a, True)
        dump_op(fh, b, True)
        dump_op(fh, x, x.data is not None)


def main(argv=None):
    """Echo a parsed legacy file (the reference's test_legacy_reader CLI,
    example/tfqmrgpu_example_reader.cxx)."""
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m tfqmrgpu_tpu_torch.io.legacy <file> [echo]")
        return 1
    echo = int(argv[1]) if len(argv) > 1 else 1
    p = read_legacy(argv[0], echo=echo)
    print(f"# tolerance {p.tolerance}")
    for op in (p.a, p.b, p.x):
        print(f"# {op.name}: {op.nrows} x {op.ncols} block rows/cols, "
              f"nnzb={op.nnzb}, block="
              f"{op.data.shape[1:] if op.data is not None else '(pattern)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

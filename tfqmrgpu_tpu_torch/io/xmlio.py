"""XML problem file I/O.

Schema parity with the reference (writer: xml_export_operator,
tfqmrgpu_generate_FD_example.cxx:144-234; reader:
tfqmrgpu_example_xml_reader.hxx:105-295):

    <LinearProblem problem_kind="A*X==B" tolerance="...">
      <BlockSparseMatrix id="A|B|X">
        <SparseMatrix type="CSR">
          <CompressedSparseRow>
            <NonzerosPerRow rows="N"> ... </NonzerosPerRow>   (or <RowStart>)
            <ColumnIndex nonzeros="M"> ... </ColumnIndex>
          </CompressedSparseRow>
          <Indirection nonzeros="M"> ... </Indirection>        (optional)
        </SparseMatrix>
        <DataTensor type="real|complex" rank="3"
                    dimensions="nblocks d1 d2" scale="s"> ... </DataTensor>
      </BlockSparseMatrix>
    </LinearProblem>

The stdlib ElementTree replaces the reference's bundled rapidxml.  The
module is the JAX package's ``tfqmrgpu_tpu/io/xmlio.py`` over this
package's ``Bsr``: the writer gives the same bytes, the reader the same
arrays.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from ..bsr import Bsr


def _seq(values, per_line: int = 16) -> str:
    parts = []
    for i, v in enumerate(values):
        parts.append("\n" if i % per_line == 0 else " ")
        parts.append(f"{v:.15g}" if isinstance(v, float) else str(int(v)))
    parts.append("\n")
    return "".join(parts)


def _write_bsr(f, bsr: Bsr, indent: str, indirection=None):
    f.write(f'{indent}<SparseMatrix type="CSR">\n')
    f.write(f"{indent}  <CompressedSparseRow>\n")
    nzpr = np.diff(bsr.rowptr)
    f.write(f'{indent}    <NonzerosPerRow rows="{bsr.nrows}">')
    f.write(_seq(nzpr))
    f.write(f"{indent}    </NonzerosPerRow>\n")
    f.write(f'{indent}    <ColumnIndex nonzeros="{bsr.nnzb}">')
    f.write(_seq(bsr.colind))
    f.write(f"{indent}    </ColumnIndex>\n")
    f.write(f"{indent}  </CompressedSparseRow>\n")
    if indirection is not None:
        f.write(f'{indent}  <Indirection nonzeros="{len(indirection)}">')
        f.write(_seq(indirection))
        f.write(f"{indent}  </Indirection>\n")
    f.write(f"{indent}</SparseMatrix>\n")


def _write_operator(f, bsr: Bsr, blocks, indirection, scale: float,
                    is_complex: bool):
    f.write(f'  <BlockSparseMatrix id="{bsr.name}">\n')
    _write_bsr(f, bsr, "    ", indirection)
    nblocks = 0 if blocks is None else blocks.shape[0]
    d1 = 0 if blocks is None else blocks.shape[1]
    d2 = 0 if blocks is None else blocks.shape[2]
    ctype = "complex" if is_complex else "real"
    f.write(f'    <DataTensor type="{ctype}" rank="3" '
            f'dimensions="{nblocks} {d1} {d2}"')
    if scale != 1.0:
        f.write(f' scale="{scale:.16e}"')
    f.write(">\n")
    if blocks is not None:
        for blk in blocks:
            for row in blk:
                if is_complex:
                    f.write(" ".join(f"{v.real:.15g}  {v.imag:.15g}"
                                     for v in row))
                else:
                    f.write(" ".join(f"{float(v):.15g}" for v in row))
                f.write("\n")
            if d1 * d2 > 1:
                f.write("\n")
    f.write("    </DataTensor>\n")
    f.write("  </BlockSparseMatrix>\n")


def write_xml(problem, filename: str):
    """Write an FdProblem (or any object with the same fields) to XML."""
    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(f'<LinearProblem problem_kind="A*X==B"\n'
                f'               generator_version="0.1" '
                f'tolerance="{problem.tolerance:.3e}">\n')
        p = problem.params
        f.write(f"  <!-- input: radius_source_blocks={p['rsb']:g}"
                f" radius_target_blocks={p['rtb']:g}\n"
                f"\t\t block_edge={p['block_edge']} "
                f"dimensions={p['dimension']} energy={p['energy']:g} "
                f"finite_difference={p['nfd']} -->\n")
        _write_operator(f, problem.a, problem.a_stencil,
                        problem.a_indirection, problem.a_scale, False)
        _write_operator(f, problem.b, problem.b_blocks,
                        problem.b_indirection, 1.0, False)
        _write_operator(f, problem.x, problem.x_reference, None, 1.0, False)
        f.write("</LinearProblem>\n")


@dataclasses.dataclass
class XmlProblem:
    """Parsed problem: expanded complex block data on every operator that
    carries a DataTensor (indirection resolved, scale applied) -- the same
    products the reference reader hands to the solver."""

    a: Bsr
    b: Bsr
    x: Bsr
    tolerance: float
    x_has_reference: bool


def _nums(text: Optional[str], dtype=np.float64) -> np.ndarray:
    if not text or not text.strip():
        return np.zeros(0, dtype)
    return np.array(text.split(), dtype=dtype)


def read_xml(filename: str, echo: int = 0) -> XmlProblem:
    """Parse a LinearProblem XML file (reader parity:
    tfqmrgpu_example_xml_reader.hxx:105-295)."""
    tree = ET.parse(filename)
    root = tree.getroot()
    if root.tag != "LinearProblem":
        raise ValueError(f"{filename}: root tag is {root.tag!r}, "
                         "expected LinearProblem")
    tolerance = float(root.attrib.get("tolerance", "0"))

    ops = {}
    x_has_ref = False
    for bsm in root:
        if bsm.tag != "BlockSparseMatrix":
            continue
        op_id = bsm.attrib.get("id", "?")
        sm = bsm.find("SparseMatrix")
        if sm is None:
            raise ValueError(f"operator {op_id}: no SparseMatrix")
        csr = sm.find("CompressedSparseRow")
        if csr is None:
            raise ValueError(f"operator {op_id}: no CompressedSparseRow")
        nzpr = csr.find("NonzerosPerRow")
        if nzpr is not None:
            counts = _nums(nzpr.text, np.int64)
            rowptr = np.concatenate([[0], np.cumsum(counts)])
        else:
            rs = csr.find("RowStart")
            if rs is None:
                raise ValueError(f"operator {op_id}: no NonzerosPerRow "
                                 "nor RowStart")
            rowptr = _nums(rs.text, np.int64)
        ci = csr.find("ColumnIndex")
        if ci is None:
            raise ValueError(f"operator {op_id}: no ColumnIndex")
        colind = _nums(ci.text, np.int64)
        nnzb = colind.shape[0]
        # reference: nCols = max - min + 1 (xml_reader.hxx:212-214)
        ncols = int(colind.max() - colind.min() + 1) if nnzb else 0

        ind = sm.find("Indirection")
        indirection = (_nums(ind.text, np.int64)
                       if ind is not None else np.arange(nnzb))

        data = None
        dt = bsm.find("DataTensor")
        if dt is not None:
            rank = int(dt.attrib.get("rank", "3"))
            dims = _nums(dt.attrib.get("dimensions", "0 0 0"), np.int64)
            assert dims.shape[0] == rank
            scale = float(dt.attrib.get("scale", "1"))
            ctype = dt.attrib.get("type", "complex")
            is_complex = ctype.lower().startswith("c")
            nb, d1, d2 = int(dims[0]), int(dims[1]), int(dims[2])
            if nb > 0:
                raw = _nums(dt.text, np.float64)
                width = 2 if is_complex else 1
                assert raw.shape[0] == nb * d1 * d2 * width, (
                    f"operator {op_id}: DataTensor has {raw.shape[0]} "
                    f"values, expected {nb * d1 * d2 * width}")
                raw = raw.reshape(nb, d1, d2, width)
                blocks = (raw[..., 0] + 1j * (raw[..., 1] if is_complex
                                              else 0.0)) * scale
                data = blocks[indirection]
                if op_id == "X":
                    x_has_ref = True
        nrows = rowptr.shape[0] - 1
        ops[op_id] = Bsr(nrows=nrows, ncols=ncols, rowptr=rowptr,
                         colind=colind, data=data, name=op_id)
        if echo > 4:
            print(f"# operator {op_id}: {nrows} rows, {ncols} cols, "
                  f"{nnzb} nonzero blocks, data={'yes' if data is not None else 'no'}")

    for req in "ABX":
        if req not in ops:
            raise ValueError(f"{filename}: operator {req} missing")
    # X's ncols must cover B's (empty trailing X columns are an error the
    # plan handles; column count comes from the pattern)
    a, b, x = ops["A"], ops["B"], ops["X"]
    ncols = max(b.ncols, x.ncols)
    b.ncols = ncols
    x.ncols = ncols
    return XmlProblem(a=a, b=b, x=x, tolerance=tolerance,
                      x_has_reference=x_has_ref)


def main(argv=None):
    """Echo a parsed XML problem (the reference's test_xml_reader CLI,
    example/tfqmrgpu_example_xml_reader.cxx)."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m tfqmrgpu_tpu_torch.io.xmlio <file.xml> [echo]")
        return 1
    echo = int(argv[1]) if len(argv) > 1 else 6
    p = read_xml(argv[0], echo=echo)
    print(f"# tolerance {p.tolerance}")
    for op in (p.a, p.b, p.x):
        shape = op.data.shape[1:] if op.data is not None else "(pattern)"
        print(f"# {op.name}: {op.nrows} x {op.ncols} block rows/cols, "
              f"nnzb={op.nnzb}, block={shape}")
    print(f"# X carries a reference solution: {p.x_has_reference}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Finite-difference example problem generator.

Reproduces the behavior of the reference's ``generate_FD_example``
(example/tfqmrgpu_generate_FD_example.cxx): a scaled and shifted Laplacian
discretized with integer-coefficient FD stencils on a grid of ``block_edge^d``
point blocks; a source cluster of blocks (radius ``rsb`` grid points) defines
the columns of B (unit blocks), and a target cluster of radius ``rtb`` around
each source defines X's sparsity pattern; A is assembled from at most
``1 + d*nFD`` distinct stencil data blocks through an indirection list
(tfqmrgpu_generate_FD_example.cxx:666-705).  An optional dense reference
solution is computed per right-hand side on the rows relevant to that RHS
(the reference uses LAPACK dgesv, :719-845; here numpy.linalg.solve).

All orderings (row enumeration by packed uint8 coordinates, cluster
iteration z-slow/x-fast, stencil block enumeration) match the reference.
The module is numpy only and produces the same problems as
``tfqmrgpu_tpu/generator.py``; ``main`` writes them to ``FD_example.xml``
with ``io.xmlio.write_xml``, as the JAX package's does:

    python -m tfqmrgpu_tpu_torch.generator [rsb] [rtb] [block_edge] [dim]
        [energy] [reference y|n] [echo] [nfd]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .bsr import Bsr

# Integer FD coefficients of the (minus) Laplacian: value[i]/denom is the
# coefficient at offset +-i (reference table,
# tfqmrgpu_generate_FD_example.cxx:350-398).  checksum(coeff[0] +
# 2*sum(coeff[1:])) == 0 for every row.
FD_COEFFS = {
    1: (1, [2, -1]),
    4: (5040, [14350, -8064, 1008, -128, 9]),
    6: (831600, [2480478, -1425600, 222750, -44000, 7425, -864, 50]),
    8: (302702400, [924708642, -538137600, 94174080, -22830080, 5350800,
                    -1053696, 156800, -15360, 735]),
}


@dataclasses.dataclass
class FdProblem:
    """Generated problem with indirection-compressed data (XML-export form)."""

    a: Bsr                       # pattern only; data via indirection
    b: Bsr
    x: Bsr
    a_indirection: np.ndarray    # uint32[nnzbA] -> stencil block id
    a_stencil: np.ndarray        # int64[nob, BS, BS] distinct stencil blocks
    a_scale: float               # 1/FDdenom
    b_indirection: np.ndarray    # uint32[nnzbB] -> 0
    b_blocks: np.ndarray         # int8[1, BS, BS] (unit block)
    x_reference: Optional[np.ndarray]  # float32[nnzbX, BS, BS] or None
    tolerance: float
    params: dict

    def a_with_data(self) -> Bsr:
        """Expand the indirection into dense complex block data (scaled)."""
        data = (self.a_stencil[self.a_indirection].astype(np.float64)
                * self.a_scale).astype(np.complex128)
        return self.a.with_data(data)

    def b_with_data(self) -> Bsr:
        data = self.b_blocks[self.b_indirection].astype(np.complex128)
        return self.b.with_data(data)

    def x_with_reference(self) -> Optional[Bsr]:
        if self.x_reference is None:
            return None
        return self.x.with_data(self.x_reference.astype(np.complex128))


def _pack_coords(xyz: np.ndarray) -> np.ndarray:
    """Pack int block coords into the reference's uint32 key: three uint8
    bytes (x, y, z) of the two's-complement coordinates
    (index4_t, tfqmrgpu_generate_FD_example.cxx:237-249)."""
    u = (np.asarray(xyz, dtype=np.int64) & 0xFF).astype(np.uint32)
    return u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)


def _create_cluster(center, radius: float, dimension: int) -> np.ndarray:
    """Block coords within ``radius`` of ``center``; iteration order
    z-slow / x-fast (create_cluster, tfqmrgpu_generate_FD_example.cxx:252-300).
    Returns int array [n, 3]."""
    irad = int(np.ceil(radius))
    rad2 = radius * radius
    out = []
    zr = range(center[2] - irad, center[2] + irad + 1) if dimension > 2 \
        else [0]
    yr = range(center[1] - irad, center[1] + irad + 1) if dimension > 1 \
        else [0]
    xr = range(center[0] - irad, center[0] + irad + 1)
    for z in zr:
        z2 = (center[2] - z) ** 2 if dimension > 2 else 0
        for y in yr:
            y2 = (center[1] - y) ** 2 if dimension > 1 else 0
            for x in xr:
                if (center[0] - x) ** 2 + y2 + z2 <= rad2:
                    out.append((x, y if dimension > 1 else 0,
                                z if dimension > 2 else 0))
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def _stencil_blocks(nfd: int, block_edge: int, dimension: int):
    """Enumerate distinct stencil block offsets in reference order
    (tfqmrgpu_generate_FD_example.cxx:400-439).  Returns [nob, 3] offsets and
    the offset -> block-id map."""
    sr = (nfd - 1) // block_edge + 1
    offsets = []
    index = {}
    for isr in range(sr + 1):
        for ipm in (1, -1):
            for d in range(dimension):
                xyz = [0, 0, 0]
                xyz[d] = isr * ipm
                key = tuple(xyz)
                if key not in index:
                    index[key] = len(offsets)
                    offsets.append(xyz)
    return np.asarray(offsets, dtype=np.int64), index


def _build_stencil_data(nfd: int, block_edge: int, dimension: int,
                        energy: float, offset_index) -> np.ndarray:
    """Per-block integer stencil data (tfqmrgpu_generate_FD_example.cxx:
    648-692 loop).  Returns int64[nob, BS, BS]."""
    denom, coeff = FD_COEFFS[nfd]
    be = block_edge
    bs = be * (be if dimension > 1 else 1) * (be if dimension > 2 else 1)
    nob = len(offset_index)
    stencil = np.zeros((nob, bs, bs), dtype=np.int64)
    sub_diag = round(denom * energy)

    zr = range(be) if dimension > 2 else [0]
    yr = range(be) if dimension > 1 else [0]
    central = offset_index[(0, 0, 0)]
    for z in zr:
        for y in yr:
            for x in range(be):
                ixyz = (x, y, z)
                ib = (z * be + y) * be + x
                for d in range(dimension):
                    for ifd in range(-nfd, nfd + 1):
                        j = ixyz[d] + ifd
                        shift = (j + 99 * be) // be - 99
                        m = [x, y if dimension > 1 else 0,
                             z if dimension > 2 else 0]
                        m[d] = (99 * be + j) % be
                        jb = (m[2] * be + m[1]) * be + m[0]
                        sxyz = [0, 0, 0]
                        sxyz[d] = shift
                        job = offset_index[tuple(sxyz)]
                        stencil[job, ib, jb] += coeff[abs(ifd)]
                # NOTE: reproduces the reference exactly: the energy term is
                # subtracted from EVERY diagonal entry once per grid point of
                # the block, i.e. BS times in total
                # (tfqmrgpu_generate_FD_example.cxx:684-689)
                for i in range(bs):
                    stencil[central, i, i] -= sub_diag
    return stencil


def generate_fd_problem(
    rsb: float = 1.75,
    rtb: float = 6.75,
    block_edge: int = 2,
    dimension: int = 3,
    energy: float = 0.0,
    reference: bool = False,
    nfd: int = 4,
    echo: int = 0,
    tolerance: float = 1e-9,
) -> FdProblem:
    """Generate the FD example problem (defaults:
    tfqmrgpu_generate_FD_example.cxx:916-923)."""
    if nfd not in FD_COEFFS:
        if echo > 0:
            print(f"# warning nFD={nfd} but only {{1,4,6,8}} implemented, "
                  "set nFD=1")
        nfd = 1
    if dimension not in (1, 2, 3):
        raise ValueError("dimension must be 1, 2 or 3")
    denom, coeff = FD_COEFFS[nfd]
    assert coeff[0] + 2 * sum(coeff[1:]) == 0, "FD checksum"
    be = block_edge
    bs = be * (be if dimension > 1 else 1) * (be if dimension > 2 else 1)

    offsets, offset_index = _stencil_blocks(nfd, be, dimension)
    nob = offsets.shape[0]
    stencil = _build_stencil_data(nfd, be, dimension, energy, offset_index)

    # ---- source cluster (columns of B), target clusters (X pattern)
    sources = _create_cluster((0, 0, 0), rsb / be, dimension)
    n_sources = sources.shape[0]
    targets = [ _create_cluster(tuple(s), rtb / be, dimension)
                for s in sources ]
    if echo > 1:
        print(f"# {nob} nonzero stencil blocks, {n_sources} source blocks")

    # ---- row enumeration: all distinct target blocks ordered by packed key
    #      (tfqmrgpu_generate_FD_example.cxx:561-575)
    all_keys = np.concatenate([_pack_coords(t) for t in targets])
    row_keys = np.unique(all_keys)          # ascending packed uint32
    nrows = row_keys.shape[0]
    row_index = {int(k): i for i, k in enumerate(row_keys)}
    if echo > 3:
        print(f"# {nrows} nonzero rows")

    # ---- X pattern: per row, ascending source columns
    x_cols_per_row = [[] for _ in range(nrows)]
    for isrc in range(n_sources):
        for k in _pack_coords(targets[isrc]):
            x_cols_per_row[row_index[int(k)]].append(isrc)
    rowptr_x, colind_x = [0], []
    for r in range(nrows):
        colind_x.extend(x_cols_per_row[r])
        rowptr_x.append(len(colind_x))
    x = Bsr(nrows, n_sources, np.array(rowptr_x), np.array(colind_x),
            None, name="X")

    # ---- B pattern: one unit block per source at the source's row
    #      (tfqmrgpu_generate_FD_example.cxx:591-625)
    src_rows = np.array([row_index[int(k)] for k in _pack_coords(sources)])
    src_of_row = {int(r): isrc for isrc, r in enumerate(src_rows)}
    rowptr_b, colind_b = [0], []
    for r in range(nrows):
        if r in src_of_row:
            colind_b.append(src_of_row[r])
        rowptr_b.append(len(colind_b))
    b = Bsr(nrows, n_sources, np.array(rowptr_b), np.array(colind_b),
            None, name="B")
    unit = np.zeros((1, bs, bs), dtype=np.int8)
    np.fill_diagonal(unit[0], 1)

    # ---- A pattern via the stencil (tfqmrgpu_generate_FD_example.cxx:666-705)
    row_coords = np.stack([(row_keys >> 0) & 0xFF, (row_keys >> 8) & 0xFF,
                           (row_keys >> 16) & 0xFF], axis=1).astype(np.int64)
    row_coords = np.where(row_coords >= 128, row_coords - 256, row_coords)
    rowptr_a, colind_a, indir_a = [0], [], []
    for r in range(nrows):
        for iob in range(nob):
            key = int(_pack_coords(row_coords[r] + offsets[iob]))
            j = row_index.get(key, -1)
            if j >= 0:
                colind_a.append(j)
                indir_a.append(iob)
        rowptr_a.append(len(colind_a))
    a = Bsr(nrows, nrows, np.array(rowptr_a), np.array(colind_a),
            None, name="A")
    if echo > 3:
        print(f"# operator has {a.nnzb} nonzero blocks")

    # ---- optional dense reference solution per RHS (:719-845)
    x_ref = None
    if reference:
        x_ref = np.zeros((x.nnzb, bs, bs), dtype=np.float32)
        a_rowptr = np.array(rowptr_a)
        a_colind = np.array(colind_a)
        a_indir = np.array(indir_a)
        stencil_scaled = stencil.astype(np.float64) / denom
        for isrc in range(n_sources):
            t_rows = np.array([row_index[int(k)]
                               for k in _pack_coords(targets[isrc])])
            slot = -np.ones(nrows, dtype=np.int64)
            slot[t_rows] = np.arange(t_rows.shape[0])
            nrel = t_rows.shape[0]
            nd = nrel * bs
            a_dense = np.zeros((nd, nd))
            for irow in t_rows:
                i_d = slot[irow]
                for inzb in range(a_rowptr[irow], a_rowptr[irow + 1]):
                    j_d = slot[a_colind[inzb]]
                    if j_d >= 0:
                        a_dense[i_d * bs:(i_d + 1) * bs,
                                j_d * bs:(j_d + 1) * bs] = \
                            stencil_scaled[a_indir[inzb]]
            rhs = np.zeros((nd, bs))
            i_d = slot[src_rows[isrc]]
            rhs[i_d * bs:(i_d + 1) * bs] = np.eye(bs)
            sol = np.linalg.solve(a_dense, rhs)
            # scatter the solution into X blocks of column isrc
            for irow in t_rows:
                i_d = slot[irow]
                lo, hi = rowptr_x[irow], rowptr_x[irow + 1]
                pos = lo + x_cols_per_row[irow].index(isrc)
                x_ref[pos] = sol[i_d * bs:(i_d + 1) * bs]

    return FdProblem(
        a=a, b=b, x=x,
        a_indirection=np.asarray(indir_a, dtype=np.uint32),
        a_stencil=stencil,
        a_scale=1.0 / denom,
        b_indirection=np.zeros(b.nnzb, dtype=np.uint32),
        b_blocks=unit,
        x_reference=x_ref,
        tolerance=tolerance,
        params=dict(rsb=rsb, rtb=rtb, block_edge=be, dimension=dimension,
                    energy=energy, nfd=nfd, bs=bs),
    )


def main(argv=None):
    """CLI mirroring the reference generator's positional arguments
    (tfqmrgpu_generate_FD_example.cxx:915-923): writes ``FD_example.xml``
    in the working directory."""
    import sys

    from .io.xmlio import write_xml

    args = list(sys.argv[1:] if argv is None else argv)

    def pop(default, cast):
        return cast(args.pop(0)) if args else default

    rsb = abs(pop(1.75, float))
    rtb = abs(pop(6.75, float))
    be = pop(2, int)
    dim = pop(3, int)
    energy = pop(0.0, float)
    ref = pop("n", str)
    echo = pop(5, int)
    nfd = pop(4, int)
    prob = generate_fd_problem(rsb, rtb, be, dim, energy,
                               reference=not ref.lower().startswith("n"),
                               nfd=nfd, echo=echo)
    write_xml(prob, "FD_example.xml")
    if echo > 1:
        print('# file "FD_example.xml" written')
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

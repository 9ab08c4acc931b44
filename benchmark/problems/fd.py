"""The FD configuration's operator: a frozen copy of the FD example
generator, with a potential on the diagonal.

The pattern and the stencil data follow the reference library's
``example/tfqmrgpu_generate_FD_example.cxx`` (orderings of rows, clusters
and stencil blocks included; the port's ``generator.py`` reproduces the
same, and ``benchmark/tests`` holds this copy against it).  The copy is
kept here so that the benchmark's inputs do not move when the program's
generator changes.  The dense reference solution of the generator is not
copied: the benchmark's reference is ``benchmark/reference``.

A = -Laplacian (8th-order stencil, nFD 4, spectrum in [0, 3 * 6.5016]) plus
a real potential V, uniform in [v_lo, v_hi] per grid point, drawn from the
configuration's ``potential_seed``: the same system in every run, so that
every run does the same work (the run's seed orders the contour and picks
the answers judged); B holds the unit blocks of the source cluster.
"""

from __future__ import annotations

import numpy as np

from . import Problem, sub_seed

FD_COEFFS = {
    1: (1, [2, -1]),
    4: (5040, [14350, -8064, 1008, -128, 9]),
    6: (831600, [2480478, -1425600, 222750, -44000, 7425, -864, 50]),
    8: (302702400, [924708642, -538137600, 94174080, -22830080, 5350800,
                    -1053696, 156800, -15360, 735]),
}


def _pack_coords(xyz: np.ndarray) -> np.ndarray:
    """Block coordinates -> the reference's uint32 key, three uint8 bytes
    (x, y, z) of the two's-complement coordinates (:237-249)."""
    u = (np.asarray(xyz, dtype=np.int64) & 0xFF).astype(np.uint32)
    return u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)


def _create_cluster(center, radius: float, dimension: int) -> np.ndarray:
    """Block coordinates within ``radius`` of ``center``, z slow and x fast
    (create_cluster, :252-300).  Returns int64 [n, 3]."""
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
    """The distinct stencil block offsets in reference order (:400-439):
    [nob, 3] offsets and the offset -> block id map."""
    sr = (nfd - 1) // block_edge + 1
    offsets, index = [], {}
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


def _stencil_data(nfd: int, block_edge: int, dimension: int,
                  offset_index) -> np.ndarray:
    """Integer stencil data of every stencil block (:648-692) at energy 0:
    int64 [nob, BS, BS]."""
    _, coeff = FD_COEFFS[nfd]
    be = block_edge
    bs = be ** dimension
    stencil = np.zeros((len(offset_index), bs, bs), dtype=np.int64)
    zr = range(be) if dimension > 2 else [0]
    yr = range(be) if dimension > 1 else [0]
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
                        stencil[offset_index[tuple(sxyz)], ib, jb] += \
                            coeff[abs(ifd)]
    return stencil


def patterns(rsb: float, rtb: float, block_edge: int, dimension: int,
             nfd: int) -> dict:
    """The generator's patterns (:561-705): rows ordered by packed key, X
    per row in ascending source columns, B one unit block per source, A
    through the stencil with its indirection into the stencil blocks."""
    be = block_edge
    offsets, offset_index = _stencil_blocks(nfd, be, dimension)
    sources = _create_cluster((0, 0, 0), rsb / be, dimension)
    targets = [_create_cluster(tuple(s), rtb / be, dimension)
               for s in sources]
    row_keys = np.unique(np.concatenate([_pack_coords(t) for t in targets]))
    nrows = row_keys.shape[0]
    row_index = {int(k): i for i, k in enumerate(row_keys)}
    x_cols = [[] for _ in range(nrows)]
    for isrc, t in enumerate(targets):
        for k in _pack_coords(t):
            x_cols[row_index[int(k)]].append(isrc)
    src_rows = np.array([row_index[int(k)] for k in _pack_coords(sources)])
    src_of_row = {int(r): isrc for isrc, r in enumerate(src_rows)}
    b_cols = [[src_of_row[r]] if r in src_of_row else [] for r in range(nrows)]
    coords = np.stack([(row_keys >> s) & 0xFF for s in (0, 8, 16)],
                      axis=1).astype(np.int64)
    coords = np.where(coords >= 128, coords - 256, coords)
    a_cols, indir = [], []
    for r in range(nrows):
        cols, ids = [], []
        for iob in range(offsets.shape[0]):
            j = row_index.get(int(_pack_coords(coords[r] + offsets[iob])), -1)
            if j >= 0:
                cols.append(j)
                ids.append(iob)
        a_cols.append(cols)
        indir.extend(ids)
    stencil = _stencil_data(nfd, be, dimension, offset_index)
    return dict(nrows=nrows, ncols=len(sources), a_cols=a_cols,
                x_cols=x_cols, b_cols=b_cols, indir=np.asarray(indir),
                stencil=stencil, denom=FD_COEFFS[nfd][0],
                central=offset_index[(0, 0, 0)])


def build(config: dict, seed: int, device) -> Problem:
    """The FD problem of ``config`` with its potential V (``seed``, the
    run's, takes no part: V comes from ``config["potential_seed"]``)."""
    import torch

    p = patterns(config["rsb"], config["rtb"], config["block_edge"],
                 config["dimension"], config["nfd"])
    bs = config["block_edge"] ** config["dimension"]
    a = (p["stencil"][p["indir"]] / p["denom"]).astype(np.complex128)
    nrows = p["nrows"]
    lo, hi = config["potential"]
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(config["potential_seed"], "V"))
    v = torch.rand((nrows, bs), generator=gen, dtype=torch.float64,
                   device=device)
    v = (lo + (hi - lo) * v).cpu().numpy()
    prob = Problem.from_columns(nrows, p["ncols"], p["a_cols"], p["x_cols"],
                                p["b_cols"], bs, bs)
    diag = a[prob.diag]
    diag[:, np.arange(bs), np.arange(bs)] += v
    a[prob.diag] = diag
    unit = np.eye(bs, dtype=np.complex128)
    prob.b_data = np.broadcast_to(unit, (prob.b_colind.shape[0], bs, bs)).copy()
    prob.operator = a
    return prob


def band_edge(nfd: int, dimension: int) -> float:
    """The top of the stencil's spectrum: |c0| + 2 sum |ck| an axis."""
    denom, coeff = FD_COEFFS[nfd]
    return dimension * (abs(coeff[0]) + 2 * sum(map(abs, coeff[1:]))) / denom

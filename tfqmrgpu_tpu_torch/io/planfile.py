"""Reader for SpMM multiplication-plan files.

Format (reference parser: bench_tfqmrgpu.cu:456-509): a header line
``#nnzb_for_Y_A_X= <nnzY> <nnzA> <nnzX>`` followed by one line per pair
``iY iA iX beta`` where beta == 0 starts a new Y block (accumulator cleared)
and beta == 1 continues accumulation into the same Y block.  The golden
assets test/multiplication/plan_unordered.14-287-16 and plan_reordered.*
use this format.  The module is the JAX package's
``tfqmrgpu_tpu/io/planfile.py``; it gives the same tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PlanFile:
    nnzb_y: int
    nnzb_a: int
    nnzb_x: int
    starts: np.ndarray   # uint32[nnzbY+1]
    pairs: np.ndarray    # uint32[nPairs, 2]  (iA, iX)
    y_order: np.ndarray  # int64[nnzbY]: the iY index of each group, in file order


def read_plan_file(filename: str) -> PlanFile:
    with open(filename) as f:
        header = f.readline().split()
        nnzb_y, nnzb_a, nnzb_x = int(header[-3]), int(header[-2]), int(header[-1])
        body = np.loadtxt(f, dtype=np.int64)
    if body.ndim == 1:
        body = body[None, :]
    iy, ia, ix, beta = body[:, 0], body[:, 1], body[:, 2], body[:, 3]
    # a new group starts whenever iY changes (beta flags are consistency info)
    new_group = np.ones(iy.shape[0], dtype=bool)
    new_group[1:] = iy[1:] != iy[:-1]
    assert np.all(beta[new_group] == 0), "group heads must carry beta=0"
    assert np.all(beta[~new_group] == 1), "continuations must carry beta=1"
    group_starts = np.flatnonzero(new_group)
    starts = np.concatenate([group_starts, [iy.shape[0]]]).astype(np.uint32)
    assert starts.shape[0] == nnzb_y + 1, (
        f"{starts.shape[0] - 1} Y groups, header says {nnzb_y}")
    pairs = np.stack([ia, ix], axis=1).astype(np.uint32)
    return PlanFile(nnzb_y=nnzb_y, nnzb_a=nnzb_a, nnzb_x=nnzb_x,
                    starts=starts, pairs=pairs, y_order=iy[new_group])

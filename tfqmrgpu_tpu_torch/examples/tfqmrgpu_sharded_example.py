"""Sharded example: solve A @ X == B over every rank of a process group.

The port's counterpart of ``examples/tfqmrgpu_sharded_example.py``.  The
reference library is single-GPU (tfqmrgpu_handle.hxx:4-6).  This example
shards block rows of A, X, B over the ranks with ``solve_sharded`` (one
rank per card): a float32 solve on the row tiles ('auto'), one on the
packed pairs ('pairs', K2 with the halo-overlap tile split), then a
refinement of the float32 sharded solve to float64 residuals with
``precision='m'``; it checks the results against a dense residual.

Run alone (a world of one, on the card unless ``--device cpu``):
  PYTHONPATH=. python tfqmrgpu_tpu_torch/examples/tfqmrgpu_sharded_example.py
On N cards of one machine:
  PYTHONPATH=. torchrun --nproc_per_node=N \\
      tfqmrgpu_tpu_torch/examples/tfqmrgpu_sharded_example.py
"""

import argparse

import numpy as np
import torch.distributed as dist

import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu_torch.parallel import multihost, solve_sharded

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="where each rank runs (default: its card)")
args = parser.parse_args()
multihost.initialize(device=args.device)
rank0 = dist.get_rank() == 0

mb, lm, ln, ncols = 12, 8, 8, 2
rng = np.random.default_rng(3)

# block-tridiagonal, diagonally dominant A
rows, cols = [0], []
for i in range(mb):
    cs = sorted({max(i - 1, 0), i, min(i + 1, mb - 1)})
    cols.extend(cs)
    rows.append(len(cols))
a_blocks = (rng.standard_normal((len(cols), lm, lm))
            + 1j * rng.standard_normal((len(cols), lm, lm))) * 0.2
for r in range(mb):
    for k in range(rows[r], rows[r + 1]):
        if cols[k] == r:
            a_blocks[k] += 6 * np.eye(lm)
a = tt.Bsr(mb, mb, np.asarray(rows), np.asarray(cols),
           a_blocks.astype(np.complex128), name="A")

# X pattern dense over ncols block columns; B = one block row per column
x = tt.Bsr(mb, ncols, np.arange(mb + 1) * ncols,
           np.tile(np.arange(ncols), mb),
           np.zeros((mb * ncols, lm, ln), np.complex128), name="X")
# B lives in block row 0 only (ncols blocks)
bptr = np.full(mb + 1, ncols, np.int64)
bptr[0] = 0
b_data = (rng.standard_normal((ncols, lm, ln))
          + 1j * rng.standard_normal((ncols, lm, ln)))
b = tt.Bsr(mb, ncols, bptr, np.arange(ncols),
           b_data.astype(np.complex128), name="B")

# float32 sharded solve ('auto' picks the row tiles at LM = 8)
xc, info = solve_sharded(a, x, b, tolerance=1e-5, max_iterations=300,
                         device=args.device)
if rank0:
    print(f"sharded c over {dist.get_world_size()} rank(s): "
          f"engine={info['engine']} iters={info['iterations']} "
          f"residuum={info['residuum']:.2e}")

# the same through the sharded packed pairs (K2 on every rank)
xp, info_p = solve_sharded(a, x, b, engine="pairs", tolerance=1e-5,
                           max_iterations=300, device=args.device)
if rank0:
    print(f"sharded c over {dist.get_world_size()} rank(s): "
          f"engine={info_p['engine']} iters={info_p['iterations']} "
          f"residuum={info_p['residuum']:.2e}")

# float64-residual mixed solve on the same ranks
xm, info_m = solve_sharded(a, x, b, precision="m", tolerance=1e-10,
                           max_iterations=600, device=args.device)
if rank0:
    print(f"sharded m: {info_m['c_iterations']} c-iters + "
          f"{info_m['refine_rounds']} refine rounds -> "
          f"residuum {info_m['residuum']:.2e}")

# independent dense check
ad = np.zeros((mb * lm, mb * lm), complex)
for r in range(mb):
    for k in range(rows[r], rows[r + 1]):
        ad[r * lm:(r + 1) * lm, cols[k] * lm:(cols[k] + 1) * lm] = \
            a_blocks[k]
bd = np.zeros((mb * lm, ncols * ln), complex)
bd[0:lm * 1, :] = np.hstack([b_data[c] for c in range(ncols)])


def dense_x(xb):
    return np.vstack([np.hstack([np.asarray(xb)[r * ncols + c]
                                 for c in range(ncols)]) for r in range(mb)])


rel = np.linalg.norm(ad @ dense_x(xm) - bd) / np.linalg.norm(bd)
if not rel < 1e-9:
    raise SystemExit(f"dense residual {rel:.2e} >= 1e-9")
rel_p = np.linalg.norm(ad @ dense_x(xp) - bd) / np.linalg.norm(bd)
if info_p["engine"] != "pairs" or not rel_p < 1e-4:
    raise SystemExit(f"packed pairs: {info_p['engine']}, dense residual "
                     f"{rel_p:.2e}")
if rank0:
    print(f"tfqmrgpu_sharded_example: OK (dense residual {rel:.2e}, packed "
          f"pairs {rel_p:.2e})")
dist.destroy_process_group()

"""Python example: solve A @ X == B from scipy BSR matrices with the port.

Behavior parity with the reference's Python example
(reference: example/tfqmrgpu_python_example.py, which drives the CUDA
library through ctypes over scipy.sparse.bsr_matrix); the port's Python API
does the same in two lines, on the CUDA card unless ``--device`` names
another device.

Run:  PYTHONPATH=. python tfqmrgpu_tpu_torch/examples/tfqmrgpu_python_example.py
      [--device cpu]
"""

import argparse

import numpy as np
from scipy.sparse import bsr_matrix

import tfqmrgpu_tpu_torch as tt

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="where the solve runs (default: cuda)")
args = parser.parse_args()

mb, lm, ln, ncols = 8, 4, 4, 2
rng = np.random.default_rng(42)

# block-sparse A: diagonal + one off-diagonal band, diagonally dominant
indptr = np.arange(mb + 1) * 2
indices = np.array([[i, (i + 1) % mb] for i in range(mb)]).reshape(-1)
order = np.argsort(indices.reshape(mb, 2), axis=1)
indices = np.take_along_axis(indices.reshape(mb, 2), order, 1).reshape(-1)
blocks = (rng.standard_normal((2 * mb, lm, lm))
          + 1j * rng.standard_normal((2 * mb, lm, lm)))
for i in range(mb):
    for k in range(indptr[i], indptr[i + 1]):
        if indices[k] == i:
            blocks[k] += 10 * np.eye(lm)
a_scipy = bsr_matrix((blocks, indices, indptr),
                     shape=(mb * lm, mb * lm))

# X pattern (dense over ncols columns), B subset (one block per column)
x_pat = tt.Bsr(mb, ncols, np.arange(mb + 1) * ncols,
               np.tile(np.arange(ncols), mb), None, name="X")
b_data = (rng.standard_normal((ncols, lm, ln))
          + 1j * rng.standard_normal((ncols, lm, ln)))
b = tt.Bsr(mb, ncols, np.concatenate([[0], np.cumsum(
    [1 if r < ncols else 0 for r in range(mb)])]),
    np.arange(ncols), b_data, name="B")

a = tt.Bsr.from_scipy_bsr(a_scipy, name="A")
x, info = tt.bsrsv_z(a, x_pat, b, tolerance=1e-10, max_iterations=300,
                     device=args.device)

print(f"# converged in {info.iterations_needed} iterations to "
      f"residuum {info.residuum_reached:.3e} on {args.device} "
      f"(engine {info.engine})")

# independent check: dense |A X - B|
ad = a_scipy.toarray()
xd = x.to_scipy_bsr().toarray()
bd = b.to_scipy_bsr().toarray()
dev = np.max(np.abs(ad @ xd - bd))
print(f"# max|A@X - B| = {dev:.3e}")
if not dev < 1e-7:
    raise SystemExit(f"residual {dev:.3e} >= 1e-7")
print("tfqmrgpu_python_example: OK")

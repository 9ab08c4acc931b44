"""Host walls of short solves on one card, for one tree of the repository:
what the loop's CUDA graph (``graphloop.py``) costs or saves where a solve
is a few iterations long.

    python3 tools/oneshot_walls.py [TREE] [--reps N]

TREE is a checkout of the repository (by default the one that holds this
tool); the tool imports that tree's ``tfqmrgpu_tpu_torch`` and
``chip_smoke`` (its problems and its C helpers), so that two trees, one
with the graph driver and one without, are timed by the same code.  To
compare two trees, run them in one call on one card, A B B A.  The cases:

* ``py golden z``: ``bsrsv_z`` on the golden-class 'z' system (K1, 5
  iterations): a one-call solve builds its Solver, and on the graph driver
  captures its graph;
* ``py golden c``: ``bsrsv_c`` on the golden-class 'c' system ('auto' ->
  row tiles, K3, 4 iterations);
* ``py FD z``: ``bsrsv_z`` on FD rtb=12.75 (K1, 73 iterations);
* ``C FD z``, ``C golden c``: the C library's one-call
  ``tfqmrgpu_bsrsv_z`` / ``tfqmrgpu_bsrsv_c`` (``chip_smoke.c_onecall``,
  the C call's own wall), and ``C golden z ten-step``: the C workflow
  (``chip_smoke.c_ten_steps``), as ``chip_smoke.py`` phase 15 drives them;
* ``new A golden z``, ``new A golden c``: one Solver ('auto': K1, K3), then
  ``set_matrix('A', ...)`` with a new A and ``solve``, the wall of both
  (the repeated set-A-then-solve of a caller who sweeps A's values).

Every case runs once untimed (the kernels' build and first use), then
``--reps`` times (default 5).  Prints one JSON line: the tree, the card's
name and power limit, the walls (ms) and their medians.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("oneshot_walls.py needs a CUDA device")
    import chip_smoke as cs
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch import Solver, native
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    if not os.path.abspath(tt.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {tt.__file__}, not the tree's package")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    native.build()
    lib = native.load()
    fd = generate_fd_problem(rtb=12.75, reference=True)
    fa, fb = fd.a_with_data(), fd.b_with_data()
    gz, gc = cs.golden_z_problem(), cs.golden_c_problem()
    rng = np.random.default_rng(17)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def new_a(problem, precision, tol):
        a, x, b = problem
        s = Solver(a, x, b, precision=precision, engine="auto", device=dev)
        s.solve(tolerance=tol, max_iterations=500)

        def run():
            scale = 1.0 + 0.01 * rng.random()
            s.set_matrix("A", a.data * scale)
            info = s.solve(tolerance=tol, max_iterations=500)
            assert info.return_status == 0, info.return_status
        return run

    def c_ok(out):
        assert out[0] == 0, out[0]
        return out[-1]

    cases = {
        "py golden z": lambda: wall(lambda: tt.bsrsv_z(
            *gz, tolerance=1e-10, max_iterations=500, device=dev)),
        "py golden c": lambda: wall(lambda: tt.bsrsv_c(
            *gc, tolerance=1e-5, max_iterations=500, device=dev)),
        "py FD z": lambda: wall(lambda: tt.bsrsv_z(
            fa, fd.x, fb, tolerance=1e-9, max_iterations=2000, device=dev)),
        "C FD z": lambda: c_ok(cs.c_onecall(lib, "z", fa, fd.x, fb, 1e-9,
                                            2000)),
        "C golden c": lambda: c_ok(cs.c_onecall(lib, "c", *gc, 1e-5, 500)),
        "C golden z ten-step": lambda: cs.c_ten_steps(lib, *gz, 1e-10,
                                                      500)[-1],
    }
    runs = {"new A golden z": new_a(gz, "z", 1e-10),
            "new A golden c": new_a(gc, "c", 1e-5)}
    for name, run in runs.items():
        cases[name] = (lambda r: lambda: wall(r))(run)
    walls = {}
    for name, case in cases.items():
        case()                                  # build and first use
        walls[name] = [case() for _ in range(args.reps)]
    print(json.dumps({
        "tree": tree, "card": card, "reps": args.reps,
        "median_ms": {k: statistics.median(v) for k, v in walls.items()},
        "walls_ms": walls}), flush=True)


if __name__ == "__main__":
    main()

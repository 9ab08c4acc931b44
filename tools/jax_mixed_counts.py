"""The JAX package's mixed precision 'm' on an FD example, on the CPU:

    JAX_PLATFORMS=cpu TFQ_XLA_OZ=0 python3 tools/jax_mixed_counts.py [rtb ...]

For each radius (default 6.75 and 12.75) it runs ``tfqmrgpu_tpu.bsrsv_m``
at tolerance 1e-9 with at most 2000 iterations and prints one JSON line:
the c-stage engine and iterations, the refinement iterations and correction
rounds, whether the 'z' fallback ran, the residuum, the deviation from the
generator's dense reference and the wall time.  ``chip_smoke.py`` prints
the FD rtb=12.75 counts beside the port's; TFQ_XLA_OZ=0 keeps the float64
products native (no Ozaki slices).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    os.environ.setdefault("TFQ_XLA_OZ", "0")
    import jax

    jax.config.update("jax_enable_x64", True)
    import tfqmrgpu_tpu as tq
    from tfqmrgpu_tpu import refine, solver
    from tfqmrgpu_tpu.generator import generate_fd_problem

    radii = [float(v) for v in (sys.argv[1:] if argv is None else argv)]
    for rtb in radii or [6.75, 12.75]:
        seen = {}
        loop, solve_c = refine.refinement_loop, solver.Solver.solve

        def counted(**kw):
            res = loop(**kw)
            seen["rounds"] = res["rounds"]
            seen["refine_converged"] = res["converged"]
            return res

        def first_solve(self, *a, **kw):
            info = solve_c(self, *a, **kw)
            seen.setdefault("c", (self.engine, info.iterations_needed,
                                  info.residuum_reached))
            return info

        refine.refinement_loop = counted
        solver.Solver.solve = first_solve
        prob = generate_fd_problem(rtb=rtb, reference=True)
        t0 = time.perf_counter()
        try:
            xs, info = tq.bsrsv_m(prob.a_with_data(), prob.x,
                                  prob.b_with_data(), tolerance=1e-9,
                                  max_iterations=2000)
        finally:
            refine.refinement_loop, solver.Solver.solve = loop, solve_c
        wall = time.perf_counter() - t0
        ref = prob.x_reference.astype(np.float64)
        engine, c_iters, c_res = seen["c"]
        print(json.dumps(dict(
            rtb=rtb, c_engine=engine, c_iterations=c_iters,
            c_residuum=c_res, iterations=info.iterations_needed,
            refinement_iterations=info.iterations_needed - c_iters,
            rounds=seen["rounds"],
            fallback=not seen["refine_converged"],
            status=info.return_status, residuum=info.residuum_reached,
            maxdev=float(np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref))),
            wall_s=wall)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

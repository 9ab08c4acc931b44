"""The system under test: the port's ``Solver``, driven as a caller drives
it.  The only module of the harness that imports the program, and it takes
from it only the solver, its ``SolveInfo`` and the launch counters."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answer:
    status: int          # 0 where the solve converged
    iterations: int
    probes: int


class PortSolver:
    """One ``tfqmrgpu_tpu_torch.Solver`` over the problem's patterns, B set
    once, A set from ``a0``; engine and precision from the configuration."""

    def __init__(self, problem, a0: np.ndarray, config: dict, device):
        import tfqmrgpu_tpu_torch as tt

        p = problem
        a = tt.Bsr(p.nrows, p.nrows, p.a_rowptr, p.a_colind, a0, "A")
        x = tt.Bsr(p.nrows, p.ncols, p.x_rowptr, p.x_colind, None, "X")
        b = tt.Bsr(p.nrows, p.ncols, p.b_rowptr, p.b_colind, p.b_data, "B")
        self.solver = tt.Solver(a, x, b, precision=config["precision"],
                                engine=config["engine"], device=device)
        self.engine = self.solver.engine

    def set_a(self, a: np.ndarray):
        self.solver.set_matrix("A", a)

    def solve(self, tolerance: float, max_iterations: int) -> Answer:
        info = self.solver.solve(tolerance=tolerance,
                                 max_iterations=max_iterations)
        return Answer(int(info.return_status), int(info.iterations_needed),
                      int(info.n_probes))

    def get_x(self) -> np.ndarray:
        return self.solver.get_matrix("X")


def k1_launches():
    """K1's launches counted on the card since the process began."""
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    return PairPlanMultiply.launches

"""The reference in the program's place: the interface of
``benchmark.program.PortSolver`` over the reference's tfQMR.  In complex64
it is the control that the judge must refuse (complex128 configurations'
nearest lower precision); the tests and ``benchmark/readings.py`` run it."""

from __future__ import annotations

import numpy as np
import torch

from . import tfqmr
from .operator import Operator


class ReferenceSolver:
    def __init__(self, problem, a0: np.ndarray, config: dict, device,
                 dtype=torch.complex64):
        self.problem, self.device, self.dtype = problem, device, dtype
        self.engine = f"reference-{str(dtype).split('.')[-1]}"
        self.set_a(a0)
        self._x = None

    def set_a(self, a: np.ndarray):
        self.op = Operator(self.problem, a, self.device, self.dtype)
        self.b = self.op.rhs(self.problem.b_data)

    def solve(self, tolerance: float, max_iterations: int) -> tfqmr.Outcome:
        out = tfqmr.solve(self.op, self.b, tolerance, max_iterations)
        self._x = out.x
        return out

    def get_x(self) -> np.ndarray:
        return self._x.to(torch.complex128).cpu().numpy()

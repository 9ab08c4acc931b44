"""The traffic generator: a cell's pool of operators along its contour.

One general generator for every mix of contour points.  A point file
(``traffic/<mix>/<config>.json``) gives the points as data: energies
E_k = center + radius * exp(i theta_k), theta_k the ``count``
Gauss-Legendre nodes on (0, pi) (``"points": "semicircle"``).

Pool entry k is the problem's operator with -E_k added to the diagonal of
every diagonal block (A - E_k I): a host array of what a caller hands to
``set_matrix('A')``.  The seed picks the first point of the cycle.
"""

from __future__ import annotations

import numpy as np

from .problems import Problem, sub_seed


def shifts(points: dict) -> np.ndarray:
    """The diagonal shifts -E_k of the points, complex128 [P]."""
    if points["points"] != "semicircle":
        raise ValueError(f"unknown kind of contour points "
                         f"{points['points']!r}")
    nodes, _ = np.polynomial.legendre.leggauss(int(points["count"]))
    theta = (nodes + 1.0) * (np.pi / 2.0)
    return -(points["center"] + points["radius"] * np.exp(1j * theta))


def make_pool(problem: Problem, sigma: np.ndarray) -> list:
    """Host arrays A_k = operator + sigma_k I (diagonal blocks), complex128
    [nnzbA, LM, LM]."""
    diag = problem.diag[:, None]
    r = np.arange(problem.lm)[None, :]
    pool = []
    for s in sigma:
        a = problem.operator.copy()
        a[diag, r, r] += s
        pool.append(a)
    return pool


def first_point(seed: int, count: int) -> int:
    return sub_seed(seed, "start") % count

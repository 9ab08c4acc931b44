"""The port's refinement loop (``tfqmrgpu_tpu_torch/refine.py``) against the
JAX package's ``refinement_loop`` on the same numpy doubles: A = I on a
trivial pattern, and correction solves that return a fixed share of the
residual (the three cases of tests/test_refine.py).  Both must take the
same rounds and iterations and reach the same verdict, with the ratio and
x to 1e-12 relative, and ask for the same correction budgets."""

import numpy as np
import pytest
import torch

from tfqmrgpu_tpu_torch.refine import refinement_loop as port_loop
from tfqmrgpu_tpu.refine import refinement_loop as jax_loop

torch.set_num_threads(2)


def _identity_setup(ncols=2, lm=2, ln=3, nnzb=4):
    """A == I: the residual of the iterate x is b - x."""
    colindx = np.arange(nnzb, dtype=np.int64) % ncols
    rng = np.random.default_rng(0)
    bx = (rng.standard_normal((nnzb, lm, ln))
          + 1j * rng.standard_normal((nnzb, lm, ln)))
    bn2 = np.zeros((ncols, ln))
    np.add.at(bn2, colindx, (np.abs(bx) ** 2).sum(axis=1))
    return bx, colindx, bn2


def _run_both(share, iters, **kw):
    """Both loops with a correction that returns ``share`` of the residual
    and reports ``iters`` iterations (``None``: the whole budget)."""
    bx, colindx, bn2 = _identity_setup()
    budgets = {"jax": [], "port": []}

    def jax_correction(r, res2, stall, inner_max):
        budgets["jax"].append((inner_max, stall))
        rr, ri = np.asarray(r[0]), np.asarray(r[1])
        return (share * rr, share * ri), inner_max if iters is None else iters

    def port_correction(r, res2, stall, inner_max):
        budgets["port"].append((inner_max, stall))
        assert r[0].dtype == res2.dtype == torch.float64
        return ((share * r[0], share * r[1]),
                inner_max if iters is None else iters)

    common = dict(bx64=bx, colindx=colindx, bn2=bn2, x0=np.zeros_like(bx),
                  **kw)
    want = jax_loop(apply64=lambda xr, xi: (np.asarray(xr), np.asarray(xi)),
                    solve_correction=jax_correction, **common)
    got = port_loop(apply64=lambda xr, xi: (xr, xi),
                    solve_correction=port_correction, device="cpu", **common)
    return want, got, budgets, bx


def _assert_same(want, got, budgets):
    for k in ("rounds", "total_iters", "converged"):
        assert got[k] == want[k], k
    assert got["ratio"] == pytest.approx(want["ratio"], rel=1e-12)
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-12)
    scale = np.max(np.abs(want["x"]))
    assert np.max(np.abs(got["x"] - want["x"])) <= 1e-12 * max(scale, 1e-300)
    assert got["x"].dtype == np.complex128
    assert budgets["port"] == budgets["jax"]


def test_converges_with_exact_corrections_like_jax():
    want, got, budgets, bx = _run_both(
        0.9, 7, tolerance=1e-3, max_iterations=1000, total_iters=30,
        inner_base=30, stall_seed=1e-4, flops_per_round=10.0,
        flops_per_iteration=2.0)
    _assert_same(want, got, budgets)
    assert got["converged"] and got["rounds"] in (3, 4)
    assert got["total_iters"] == 30 + 7 * got["rounds"]
    assert budgets["port"][0] == (80, 2e-4)   # min(30, 150) + 50
    assert np.max(np.abs(got["x"] - bx)) / np.max(np.abs(bx)) < 2e-3


def test_breaks_on_stall_like_jax():
    want, got, budgets, _ = _run_both(
        0.5, 5, tolerance=1e-12, max_iterations=1000, total_iters=0,
        inner_base=100, stall_seed=1e-4)
    _assert_same(want, got, budgets)
    assert not got["converged"] and got["rounds"] == 1 and got["ratio"] > 0


def test_respects_global_budget_like_jax():
    want, got, budgets, _ = _run_both(
        0.5, None, tolerance=1e-30, max_iterations=12, total_iters=0,
        inner_base=500, stall_seed=1e-4)
    _assert_same(want, got, budgets)
    assert not got["converged"] and got["total_iters"] >= 12
    assert all(b <= 12 for b, _ in budgets["port"])

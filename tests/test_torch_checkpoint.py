"""The port's initial guess, checkpointed solve, plan files and solver
surface (``get_info``, ``clear_initial_guess``) on the CPU: the cases of
tests/test_checkpoint.py on the port, plan files exchanged with the JAX
package table for table, and the surface held against the JAX solver's."""

import os

import numpy as np
import pytest
import torch

import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu_torch import Solver
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.plan import Plan
from conftest import dense_from_bsr, make_random_problem
from test_torch_panel import _port
import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu.plan import Plan as JPlan

torch.set_num_threads(2)

# the JAX plan's arrays and the dtypes its save writes
PLAN_ARRAYS = {"starts": np.uint32, "pairs": np.uint32, "subset": np.uint32,
               "colindx": np.uint16, "original_colind_x": np.int32,
               "rowptr_x": np.int32, "colind_x": np.int32,
               "rowptr_b": np.int32, "colind_b": np.int32,
               "rowptr_a": np.int32, "colind_a": np.int32}


def _dense_residual(a, x, b, xc, lm, ln):
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(xc), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    return np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd))


@pytest.mark.parametrize("engine,prec", [("dense", "z"), ("pairs", "c"),
                                         ("xla", "z")])
def test_initial_guess_reduces_iterations(rng, engine, prec):
    lm = ln = 4
    dt = np.complex64 if prec == "c" else np.complex128
    a, x, b = _port(*make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                         x_fill=1.0, dtype=dt))
    tol = 1e-5 if prec == "c" else 1e-9
    s = Solver(a, x, b, precision=prec, engine=engine, device="cpu")
    info0 = s.solve(tolerance=tol, max_iterations=400)
    assert info0.return_status == Status.SUCCESS
    x_sol = s.get_matrix("X")
    # restarting from the solution converges (near-)immediately
    s2 = Solver(a, x, b, precision=prec, engine=engine, device="cpu")
    s2.set_matrix("X", x_sol)
    info1 = s2.solve(tolerance=tol, max_iterations=400)
    assert info1.return_status == Status.SUCCESS
    assert info1.iterations_needed <= max(3, info0.iterations_needed // 3)
    # and the returned X (X0 + dX) still solves the system
    gate = 1e-3 if prec == "c" else 1e-7
    assert _dense_residual(a, x, b, s2.get_matrix("X"), lm, ln) < gate


@pytest.mark.parametrize("engine", ["dense", "pairs"])
def test_checkpointed_solve_resumes(tmp_path, rng, engine):
    lm = ln = 4
    a, x, b = _port(*make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3,
                                         x_fill=1.0))
    state = str(tmp_path / "state")         # the .npz suffix is added
    ref_iters = Solver(a, x, b, engine=engine, device="cpu").solve(
        tolerance=1e-10, max_iterations=500).iterations_needed
    # tiny chunks with persistence; a crash after the first chunk
    s1 = Solver(a, x, b, engine=engine, device="cpu")
    quarter = max(2, ref_iters // 4)
    info = s1.solve_checkpointed(tolerance=1e-10, max_iterations=quarter,
                                 chunk=quarter, state_path=state)
    assert info.return_status != Status.SUCCESS          # interrupted
    assert os.path.exists(state + ".npz")
    with np.load(state + ".npz") as st:
        assert int(st["iterations"]) == quarter
    assert s1.get_info() is info
    # a new process resumes from the state file and finishes
    s2 = Solver(a, x, b, engine=engine, device="cpu")
    info2 = s2.solve_checkpointed(tolerance=1e-10, max_iterations=500,
                                  chunk=max(2, ref_iters // 2),
                                  state_path=state)
    assert info2.return_status == Status.SUCCESS
    assert not os.path.exists(state + ".npz")            # cleaned up
    assert quarter < info2.iterations_needed <= 500
    assert _dense_residual(a, x, b, s2.get_matrix("X"), lm, ln) < 1e-8
    # a state file at the budget returns at once with MAX_ITERATIONS
    np.savez(state, x_re=np.zeros((x.nnzb, lm, ln)),
             x_im=np.zeros((x.nnzb, lm, ln)), iterations=7)
    done = Solver(a, x, b, engine=engine, device="cpu").solve_checkpointed(
        max_iterations=7, state_path=state)
    assert done.return_status == Status.MAX_ITERATIONS
    assert done.iterations_needed == 7 and np.isnan(done.residuum_reached)


def test_plan_save_load(tmp_path, rng):
    a, x, b = _port(*make_random_problem(rng, mb=9, lm=4, ln=8, ncols=2))
    plan = tt.create_plan(a, x, b, device="cpu")
    plan.lm, plan.ln = 4, 8
    path = str(tmp_path / "plan.npz")
    plan.save(path)
    p2 = Plan.load(path, device="cpu")
    for k in ("pairs", "starts", "colindx", "subset"):
        assert torch.equal(getattr(p2, k), getattr(plan, k))
    assert (p2.nrows, p2.ncols, p2.lm, p2.ln) == (plan.nrows, plan.ncols, 4, 8)
    # a loaded plan drives a Solver without re-analysis
    info = Solver(a, x, b, plan=p2, device="cpu").solve(
        tolerance=1e-8, max_iterations=300)
    assert info.return_status == Status.SUCCESS


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_plan_files_cross_packages(tmp_path, rng, saver):
    """A plan saved by either package loads in the other with bit-identical
    tables: the same arrays in the same dtypes, and the same counts."""
    ja, jx, jb = make_random_problem(rng, mb=11, lm=4, ln=4, ncols=3,
                                     x_fill=0.5)
    jp = tq.create_plan(ja, jx, jb, cache=False)
    tp = tt.create_plan(*_port(ja, jx, jb), device="cpu")
    for p in (jp, tp):
        p.lm, p.ln, p.precision = 4, 4, "c"
    path = str(tmp_path / "plan.npz")
    (jp if saver == "jax" else tp).save(path)
    with np.load(path) as z:
        for k, dt in PLAN_ARRAYS.items():
            assert z[k].dtype == dt, k
            assert np.array_equal(z[k], getattr(jp, k)), k
    jl, tl = JPlan.load(path), Plan.load(path, device="cpu")
    for k, dt in PLAN_ARRAYS.items():
        got = getattr(jl, k)
        assert got.dtype == dt and np.array_equal(got, getattr(jp, k)), k
        t = getattr(tl, k)
        assert np.array_equal(t.numpy() if torch.is_tensor(t) else t,
                              getattr(jp, k)), k
    for k in ("nrows", "ncols", "nnzb_a", "nnzb_x", "nnzb_b", "lm", "ln",
              "precision"):
        assert getattr(tl, k) == getattr(jl, k) == getattr(jp, k), k


def test_get_info_and_clear_initial_guess_like_jax(monkeypatch):
    """get_info raises NO_INFO_PASSED before a solve and returns the last
    solve's info after it; clear_initial_guess makes the next solve start
    from zero again, as in the JAX package."""
    monkeypatch.setenv("TFQ_XLA_OZ", "0")
    lm = ln = 4
    a, x, b = make_random_problem(np.random.default_rng(3), mb=10, lm=lm,
                                  ln=ln, ncols=2, x_fill=1.0)
    js = jsolver.Solver(a, x, b, precision="z", engine="xla")
    ts = Solver(*_port(a, x, b), precision="z", engine="xla", device="cpu")
    for s in (js, ts):
        with pytest.raises(Exception) as e:
            s.get_info()
        assert e.value.code == Status.NO_INFO_PASSED
    counts = {}
    for name, s in (("jax", js), ("port", ts)):
        first = s.solve(tolerance=1e-9, max_iterations=300)
        assert s.get_info() is first
        s.set_matrix("X", s.get_matrix("X"))
        warm = s.solve(tolerance=1e-9, max_iterations=300)
        s.clear_initial_guess()
        cold = s.solve(tolerance=1e-9, max_iterations=300)
        assert s.get_info() is cold
        counts[name] = (first.iterations_needed, warm.iterations_needed,
                        cold.iterations_needed)
        assert warm.iterations_needed < first.iterations_needed
        assert cold.iterations_needed == first.iterations_needed
    # (the shadow vectors differ, so the counts of the packages need not)
    assert counts["port"][1] < counts["port"][0] == counts["port"][2]

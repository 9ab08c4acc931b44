"""The port's sharded row-tile, panel and mixed-precision engines
(``tfqmrgpu_tpu_torch.parallel``), with the gates of the JAX package's
``tests/test_sharded_rowtile.py``, ``test_sharded_panel.py`` and
``test_sharded_mixed.py``: iterations within one of the port's own
single-device engine and a dense residual.

The ranks run as spawned processes over gloo on the CPU
(``torch_sharded_worker.run_ranks``), where the row-tile multiply is the
plain version of K3, the packed-pairs multiply the plain version of K2 and
the float64 residual of 'm' the plain version of K1."""

import numpy as np
import pytest
import torch

import tfqmrgpu_tpu_torch as tt
from conftest import dense_from_bsr, make_random_problem
from test_torch_solver import _port
from tfqmrgpu_tpu_torch.errors import Status, TfqmrgpuError
from tfqmrgpu_tpu_torch.parallel import solve_sharded
from torch_sharded_worker import pack_problem, run_ranks

torch.set_num_threads(2)


def _dense_rel(a, x, b, got, lm, ln, norm=None):
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(np.asarray(got)), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    if norm == "fro":
        return np.linalg.norm(ad @ xd - bd) / np.linalg.norm(bd)
    return np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd))


@pytest.mark.parametrize("pr", [2, 4])
def test_rowtile_c_matches_single_device(rng, tmp_path, pr):
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0, dtype=np.complex64)
    tol = 1e-4
    s0 = tt.Solver(*_port(a, x, b), precision="c", engine="pallas",
                   device="cpu")
    i0 = s0.solve(tolerance=tol, max_iterations=300)
    got = run_ranks("rowtile", pr, dict(pack_problem(a, x, b), lm=lm, ln=ln,
                                        pr=pr, r_tile=2, tol=tol, maxit=300),
                    tmp_path)
    assert int(got["return_status"]) == 0
    assert abs(int(got["iterations"]) - i0.iterations_needed) <= 1
    assert _dense_rel(a, x, b, got["x"], lm, ln) < 50 * tol


def test_solve_sharded_auto_takes_rowtile(rng, tmp_path):
    lm = ln = 8
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    got = run_ranks("solve_sharded", 4, dict(
        pack_problem(a, x, b), runs=[["auto", "c", 1e-4, 300]]), tmp_path)
    assert int(got["0_return_status"]) == 0
    assert str(got["0_engine"]) == "rowtile"
    assert int(got["0_built"]) == 1
    assert int(got["0_k3"]) == 0            # the CPU runs K3's plain version
    assert _dense_rel(a, x, b, got["0_x"], lm, ln) < 5e-3


@pytest.mark.parametrize("pr,pc,mb,ncols,prec", [
    (4, 1, 12, 4, "c"),
    (2, 2, 12, 4, "c"),
    (4, 2, 13, 3, "c"),        # uneven: padded rows and columns
    (2, 1, 12, 4, "z"),
], ids=["rows_only", "2d", "uneven_padding", "z"])
def test_panel_matches_single_device(rng, tmp_path, pr, pc, mb, ncols,
                                     prec):
    lm = ln = 4
    dt = np.complex64 if prec == "c" else np.complex128
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                                  x_fill=1.0, dtype=dt)
    tol = 1e-5 if prec == "c" else 1e-9
    s0 = tt.Solver(*_port(a, x, b), precision=prec, engine="dense",
                   device="cpu")
    i0 = s0.solve(tolerance=tol, max_iterations=400)
    got = run_ranks("panel", pr * pc, dict(
        pack_problem(a, x, b), lm=lm, ln=ln, grid=[pr, pc], precision=prec,
        tol=tol, maxit=400), tmp_path)
    assert int(got["return_status"]) == int(Status.SUCCESS)
    assert abs(int(got["iterations"]) - i0.iterations_needed) <= 1
    gate = 1e-3 if prec == "c" else 1e-7
    assert _dense_rel(a, x, b, got["x"], lm, ln) < gate


def test_mixed_rowtile_reaches_f64_residuals(rng, tmp_path):
    """'m' pushes the relative residual far below the float32 floor
    (~1e-5) where plain 'c' stalls, and lands below it on one problem."""
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex128)
    got = run_ranks("solve_sharded", 4, dict(
        pack_problem(a, x, b),
        runs=[["rowtile", "m", 1e-9, 600], ["rowtile", "c", 1e-12, 400],
              ["rowtile", "m", 1e-10, 800]]), tmp_path)
    assert str(got["0_engine"]) == "rowtile"
    assert bool(got["0_converged"]) and int(got["0_refine_rounds"]) >= 1
    assert got["0_x"].dtype == np.complex128
    assert _dense_rel(a, x, b, got["0_x"], lm, ln, "fro") < 1e-8
    rel_c = _dense_rel(a, x, b, got["1_x"].astype(np.complex128), lm, ln,
                       "fro")
    rel_m = _dense_rel(a, x, b, got["2_x"], lm, ln, "fro")
    assert rel_m < 1e-3 * max(rel_c, 1e-30) or rel_m < 1e-10


@pytest.mark.parametrize("world", [1, 2, 4])
def test_solve_sharded_pairs_and_auto(rng, tmp_path, world):
    """The sharded packed-pairs engine through ``solve_sharded``: an
    explicit 'pairs', an 'auto' that picks it (LM < 8) and 'pairs' in 'm'
    solve to the JAX package's gates (iterations within one of the
    single-device 'pairs' solve, a dense residual below 50*tol; 'm' to
    float64 residuals), and no row-tile solver is built or run."""
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0, dtype=np.complex128)
    tol = 1e-4
    s0 = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                   device="cpu")
    i0 = s0.solve(tolerance=tol, max_iterations=300)
    got = run_ranks("solve_sharded", world, dict(
        pack_problem(a, x, b), runs=[["pairs", "c", tol, 300],
                                     ["auto", "c", tol, 300],
                                     ["pairs", "m", 1e-9, 600]]), tmp_path)
    assert int(got["world"]) == world
    for i in range(3):
        assert f"{i}_error" not in got, str(got.get(f"{i}_error"))
        assert str(got[f"{i}_engine"]) == "pairs"
        assert int(got[f"{i}_return_status"]) == 0
        assert int(got[f"{i}_built"]) == 0 and int(got[f"{i}_k3"]) == 0
    for i in range(2):
        assert abs(int(got[f"{i}_iterations"]) - i0.iterations_needed) <= 1
        assert _dense_rel(a, x, b, got[f"{i}_x"], lm, ln) < 50 * tol
    assert bool(got["2_converged"]) and got["2_x"].dtype == np.complex128
    assert _dense_rel(a, x, b, got["2_x"], lm, ln, "fro") < 1e-8


def test_plain_z_is_refused():
    lm = ln = 4
    a, x, b = make_random_problem(np.random.default_rng(0), mb=6, lm=lm,
                                  ln=ln, ncols=2, x_fill=1.0,
                                  dtype=np.complex64)
    with pytest.raises(TfqmrgpuError, match="plain 'z' runs on one device"):
        solve_sharded(*_port(a, x, b), precision="z", device="cpu")

"""The port's sharded block-list solve (``tfqmrgpu_tpu_torch.parallel``)
against the JAX package's ``sharded_solve`` on its simulated 8-device CPU
mesh, and against the port's single-device solve.

The port's ranks run as spawned processes over gloo on the CPU
(``torch_sharded_worker.run_ranks``: a FileStore under tmp_path, one thread
each, no JAX); the JAX reference runs in this process.  Both get the same
inputs from a numpy seed and JAX's shadow vector v3, so the gates are
``tests/test_sharded.py``'s own: the same status and iterations, X within
atol 1e-10 and the residuum within 1e-12."""

import numpy as np
import pytest
import torch

from conftest import make_random_problem
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu.parallel import make_mesh as jmake_mesh
from tfqmrgpu_tpu.parallel import partition_plan as jpartition_plan
from tfqmrgpu_tpu.parallel.sharded import sharded_solve as jsharded_solve
from tfqmrgpu_tpu.plan import create_plan as jcreate_plan
from torch_sharded_worker import pack_problem, run_ranks

torch.set_num_threads(2)


def _jax_sharded(a, x, b, lm, ln, pr, pc, tol, maxit, rhs_trivial=False):
    plan = jcreate_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    bz = (np.zeros((plan.nnzb_b, lm, ln)),) * 2 if rhs_trivial else \
        (b.data.real.copy(), b.data.imag.copy())
    x_re, x_im, info = jsharded_solve(
        plan, jpartition_plan(plan, pr, pc), jmake_mesh(pr, pc),
        a.data.real.copy(), a.data.imag.copy(), *bz, tolerance=tol,
        max_iterations=maxit, rhs_trivial=rhs_trivial)
    v3 = jcore.make_shadow_vector(plan.nnzb_x, lm, ln)
    return x_re + 1j * x_im, info, tuple(np.asarray(v) for v in v3)


def _inputs(a, x, b, lm, ln, v3, **kw):
    return dict(pack_problem(a, x, b), lm=lm, ln=ln, v3_re=v3[0],
                v3_im=v3[1], **kw)


@pytest.mark.parametrize("pr,pc", [(2, 1), (4, 1), (2, 2)])
def test_blocklist_z_matches_jax_sharded(rng, tmp_path, pr, pc):
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=24, lm=lm, ln=ln, ncols=6,
                                  x_fill=0.6)
    tol, maxit = 1e-8, 500
    want, jinfo, v3 = _jax_sharded(a, x, b, lm, ln, pr, pc, tol, maxit)
    got = run_ranks("blocklist", pr * pc, _inputs(
        a, x, b, lm, ln, v3, grid=[pr, pc], tol=tol, maxit=maxit,
        rhs_trivial=False), tmp_path)
    assert int(got["return_status"]) == jinfo["return_status"] == 0
    assert int(got["iterations"]) == jinfo["iterations"]
    np.testing.assert_allclose(got["x"], want, atol=1e-10)
    assert abs(float(got["residuum"]) - jinfo["residuum"]) < 1e-12
    # the single-device port, on the same plan and v3
    import tfqmrgpu_tpu_torch as tt
    from test_torch_solver import _port

    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu", v3=v3)
    info = s.solve(tolerance=tol, max_iterations=maxit)
    assert info.iterations_needed == int(got["iterations"])
    np.testing.assert_allclose(got["x"], s.get_matrix("X"), atol=1e-10)
    # one halo gather a multiply, two final gathers; per iteration four
    # column sums and one reduction of the decision's partials, per probe
    # two (the residual's column sums and the partials), one for |B|
    its, probes = int(got["iterations"]), int(got["n_probes"])
    assert int(got["all_gather"]) == 2 * its + probes + 2
    assert int(got["all_reduce"]) == 5 * its + 2 * probes + 1


def test_blocklist_trivial_rhs(rng, tmp_path):
    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=4,
                                  x_fill=0.8)
    want, jinfo, v3 = _jax_sharded(a, x, b, lm, ln, 2, 2, 1e-8, 500,
                                   rhs_trivial=True)
    got = run_ranks("blocklist", 4, _inputs(
        a, x, b, lm, ln, v3, grid=[2, 2], tol=1e-8, maxit=500,
        rhs_trivial=True), tmp_path)
    assert int(got["return_status"]) == 0
    assert float(got["residuum"]) <= 1e-8
    assert int(got["iterations"]) == jinfo["iterations"]
    np.testing.assert_allclose(got["x"], want, atol=1e-10)


def test_world_size_one_equals_single_device(rng, tmp_path):
    """At one rank the sharded block-list solve is the single-device 'pairs'
    solve and the sharded panel solve the 'dense' one: same iterations, the
    same bits."""
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3,
                                  x_fill=0.7)
    _, _, v3 = _jax_sharded(a, x, b, lm, ln, 1, 1, 1e-9, 300)
    got = run_ranks("world1", 1, _inputs(a, x, b, lm, ln, v3, tol=1e-9,
                                         maxit=300), tmp_path)
    assert int(got["status"]) == int(got["status1"]) == 0
    assert int(got["iterations"]) == int(got["iterations1"])
    assert np.array_equal(got["x"], got["x1"])
    assert int(got["iterations_p"]) == int(got["iterations_d"])
    assert np.array_equal(got["xp"], got["xd"])
    # a mesh never sends the collectives of card tensors through gloo
    assert "gloo process group cannot run the collectives of cuda:0" \
        in str(got["refused"])


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    return run_ranks("scaling", 2, {}, tmp_path_factory.mktemp("scaling"))


def test_weak_scaling_iteration_parity(scaling):
    """tests/test_scaling.py's gates at one and two ranks, and the same
    iterations for one problem over one and two row shards."""
    assert int(scaling["p1_status"]) == 0 and int(scaling["p2_status"]) == 0
    assert int(scaling["p2_mb"]) == 2 * int(scaling["p1_mb"])
    assert int(scaling["p2_n_pairs"]) > int(scaling["p1_n_pairs"])
    assert int(scaling["p1_16_mb"]) == int(scaling["p2_mb"])
    assert int(scaling["p1_16_iterations"]) == int(scaling["p2_iterations"])
    assert str(scaling["p2_device"]) == "cpu"


def test_weak_scaling_report_shape(scaling):
    assert scaling["rep_pr"].tolist() == [1, 2]
    assert scaling["rep_efficiency"][0] == 1.0
    assert all(int(i) > 0 for i in scaling["rep_iterations"])
    assert all(float(w) > 0 for w in scaling["rep_wall_s"])

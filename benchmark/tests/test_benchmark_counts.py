"""The yardstick's counts by hand, the pools from a seed, and the frozen
generator against the port's."""

import numpy as np
import pytest

from benchmark import cells, counts, pool, problems

H100 = "NVIDIA H100 80GB HBM3"


def _problem(config_name, seed=5):
    cell = cells.load(f"{config_name}.contour")
    return cell, problems.build(cell.config, seed, "cpu")


@pytest.mark.parametrize("name, pairs, gflop, mb, bound_ms", [
    ("fd8_z", 305397, 1.251, 80.8, 0.0241)])
def test_multiply_counts_by_hand(name, pairs, gflop, mb, bound_ms):
    cell, prob = _problem(name)
    work = counts.multiply(prob, "z")
    assert work["pairs"] == pairs
    assert work["flops"] == 8 * prob.lm ** 2 * prob.ln * pairs
    assert round(work["flops"] / 1e9, 3) == pytest.approx(gflop, abs=6e-3)
    assert round(work["bytes"] / 1e6, 1) == pytest.approx(mb, abs=0.06)
    assert 1e3 * counts.bound_seconds(work, H100) == pytest.approx(
        bound_ms, abs=1e-4)
    shapes = cell.config["shapes"]
    assert (prob.nrows, prob.ncols) == (shapes["block_rows"],
                                        shapes["block_cols"])
    assert prob.nnzb == {"A": shapes["a_blocks"], "X": shapes["x_blocks"],
                         "B": shapes["b_blocks"]}
    assert shapes["pairs"] == pairs
    assert shapes["rhs"] == prob.ncols * prob.ln


def test_unknown_card_has_no_bound():
    with pytest.raises(KeyError):
        counts.bound_seconds({"flops": 1.0, "bytes": 1.0}, "some other card")


def test_fd_contour_points():
    cell = cells.load("fd8_z.contour")
    energy = -pool.shifts(cell.points)
    nodes, _ = np.polynomial.legendre.leggauss(16)
    theta = np.angle(energy - cell.points["center"])
    assert np.allclose(np.sort(theta), (nodes + 1) * np.pi / 2)
    assert np.allclose(np.abs(energy - cell.points["center"]),
                       cell.points["radius"])
    assert (energy.imag > 0).all()
    assert energy.real.min() > -20.0 - 1e-9 and energy.real.max() < 0.5


def test_pools_repeat_from_a_seed():
    """Every run solves the same systems (V from the configuration's
    ``potential_seed``); the run's seed picks where the cycle starts."""
    cell = cells.load("fd8_z.contour")

    def make(config, seed):
        prob = problems.build(config, seed, "cpu")
        return prob, pool.make_pool(prob, pool.shifts(cell.points)[:2])

    big = 2 ** 33 + 12345
    (p1, a1), (p2, a2) = make(cell.config, big), make(cell.config, big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a1, a2))
    assert np.array_equal(p1.b_data, p2.b_data)
    _, a3 = make(dict(cell.config, potential_seed=2), big)
    assert not np.array_equal(a1[0], a3[0])
    assert pool.first_point(big, 16) == pool.first_point(big, 16)
    assert {pool.first_point(s, 16) for s in range(400)} == set(range(16))


def test_fd_potential_lies_in_its_interval():
    cell = cells.load("fd8_z.contour")
    cfg = dict(cell.config, rsb=1.75, rtb=4.75)
    plain = problems.fd.patterns(cfg["rsb"], cfg["rtb"], 2, 3, 4)
    base = (plain["stencil"][plain["indir"]] / plain["denom"])
    prob = problems.build(cfg, 9, "cpu")
    diff = prob.operator - base
    d = prob.diag
    v = np.einsum("kii->ki", diff[d]).real
    assert v.min() >= -0.25 and v.max() <= 0.0 and v.std() > 0.01
    diff[d] -= np.einsum("ki,ij->kij", v, np.eye(8))
    assert not diff.any()


def test_fd_band_edge():
    assert problems.fd.band_edge(4, 3) == pytest.approx(3 * 6.5016, abs=1e-3)


def test_frozen_generator_gives_the_ports_fd_problem():
    """At the cell's shapes: the same patterns and A data (V = 0) as the
    port's generator."""
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    cell = cells.load("fd8_z.contour")
    c = cell.config
    port = generate_fd_problem(rsb=c["rsb"], rtb=c["rtb"],
                               block_edge=c["block_edge"],
                               dimension=c["dimension"], nfd=c["nfd"])
    mine = problems.fd.patterns(c["rsb"], c["rtb"], c["block_edge"],
                                c["dimension"], c["nfd"])
    prob = problems.Problem.from_columns(
        mine["nrows"], mine["ncols"], mine["a_cols"], mine["x_cols"],
        mine["b_cols"], 8, 8)
    for name, bsr in (("a", port.a), ("x", port.x), ("b", port.b)):
        assert np.array_equal(getattr(prob, f"{name}_rowptr"), bsr.rowptr)
        assert np.array_equal(getattr(prob, f"{name}_colind"), bsr.colind)
    a = mine["stencil"][mine["indir"]] / mine["denom"]
    assert np.array_equal(a, port.a_with_data().data.real)
    assert np.array_equal(mine["indir"], port.a_indirection)

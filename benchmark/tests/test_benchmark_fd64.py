"""The configuration fd64_z (the FD generator's 64-point blocks) and the
readers of its cell's per-layer metrics: its shapes from the frozen
generator, the frozen generator against the port's at block_edge 4, the
hand counts of one multiply, and ``k1_roofline``, ``k1_ms_per_iter`` and
``pass_ms_per_iter`` on synthetic traces at the cell's K1 instantiation."""

import numpy as np
import pytest

from benchmark import cells, counts, problems, tracing
from benchmark.metrics import k1_ms_per_iter, k1_roofline, pass_ms_per_iter
from benchmark.problems import fd

H100 = "NVIDIA H100 80GB HBM3"
CELL = cells.load("fd64_z.contour")


def _patterns(c):
    return fd.patterns(c["rsb"], c["rtb"], c["block_edge"], c["dimension"],
                       c["nfd"])


def _problem(c, lm):
    p = _patterns(c)
    return p, problems.Problem.from_columns(
        p["nrows"], p["ncols"], p["a_cols"], p["x_cols"], p["b_cols"], lm, lm)


def test_shapes_are_the_generators():
    c = CELL.config
    assert (c["lm"], c["ln"]) == (64, 64) == (c["block_edge"] ** 3,) * 2
    assert c["reduced"] == [] and c["precision"] == "z"
    _, prob = _problem(c, 64)
    shapes = c["shapes"]
    assert (prob.nrows, prob.ncols) == (shapes["block_rows"],
                                        shapes["block_cols"])
    assert prob.nnzb == {"A": shapes["a_blocks"], "X": shapes["x_blocks"],
                         "B": shapes["b_blocks"]}
    assert shapes["rhs"] == prob.ncols * prob.ln == 1728
    work = counts.multiply(prob, "z")
    assert work["pairs"] == shapes["pairs"] == 21789
    # by hand: 8 LM^3 a pair; A once, X and Y once each, complex128
    assert work["flops"] == 8 * 64 ** 3 * 21789 == 45_694_844_928
    assert work["bytes"] == 16 * 64 * 64 * (2813 + 2 * 3969) == 704_577_536
    assert 1e3 * counts.bound_seconds(work, H100) == pytest.approx(
        0.68201, abs=1e-5)                          # operations, not bytes


def test_the_contour_is_fd8_zs():
    assert CELL.points == cells.load("fd8_z.contour").points


def test_frozen_generator_gives_the_ports_fd_problem_at_block_edge_4():
    """At the cell's shapes: the same patterns and A data (V = 0) as the
    port's generator."""
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    c = CELL.config
    port = generate_fd_problem(rsb=c["rsb"], rtb=c["rtb"],
                               block_edge=c["block_edge"],
                               dimension=c["dimension"], nfd=c["nfd"])
    mine, prob = _problem(c, 64)
    for name, bsr in (("a", port.a), ("x", port.x), ("b", port.b)):
        assert np.array_equal(getattr(prob, f"{name}_rowptr"), bsr.rowptr)
        assert np.array_equal(getattr(prob, f"{name}_colind"), bsr.colind)
    assert np.array_equal(mine["indir"], port.a_indirection)
    a = mine["stencil"][mine["indir"]] / mine["denom"]
    assert np.array_equal(a, port.a_with_data().data.real)


K1 = "void (anonymous namespace)::pairpanel_spmm_mma_kernel<64, 64>(double const*)"
AXPAY = "void (anonymous namespace)::vecpass_axpay<double, 2, true>(double*)"
SUMS = "void (anonymous namespace)::vecpass_column_sums(double const*)"
SPANS = [("bench.set_a", 0.0, 100.0), ("bench.solve", 110.0, 3000.0),
         ("bench.solve", 4000.0, 5000.0), ("bench.get_x", 5100.0, 5200.0)]
# two solves of 3 and 1 iterations: K1 1000 us and 500 us a launch
EVENTS = [(K1, 200.0, 1200.0), (K1, 1300.0, 2300.0), (AXPAY, 2400.0, 2410.0),
          (SUMS, 2420.0, 2425.0), (K1, 4100.0, 4600.0),
          (AXPAY, 4700.0, 4720.0),
          (AXPAY, 50.0, 60.0),                      # in set A: not counted
          ("Memcpy DtoH (Device -> Pageable)", 5110.0, 5190.0)]


def _trace(events=EVENTS, launches=3, bound_s=0.5e-3, iterations=(3, 1)):
    return tracing.Trace(solves=[{"iterations": i} for i in iterations],
                         spans=SPANS, events=events, k1_launches=launches,
                         k1_bound_s=bound_s)


def test_k1_readers_read_k1_alone():
    t = _trace()
    assert k1_ms_per_iter.read(t) == pytest.approx(2.5 / 4)
    # mean launch 2500 / 3 us against a 500 us bound
    assert k1_roofline.read(t) == pytest.approx(100 * 500 / (2500 / 3))


def test_pass_reader_reads_the_passes_alone():
    assert pass_ms_per_iter.read(_trace()) == pytest.approx(0.035 / 4)


@pytest.mark.parametrize("launches", [None, 2, 4])
def test_k1_readers_refuse_a_count_that_disagrees(launches):
    t = _trace(launches=launches)
    assert k1_ms_per_iter.read(t) is None
    assert k1_roofline.read(t) is None
    assert pass_ms_per_iter.read(t) == pytest.approx(0.035 / 4)


def test_readers_read_nothing_without_their_kernels():
    no_k1 = [e for e in EVENTS if e[0] != K1]
    t = _trace(no_k1, launches=0)
    assert k1_ms_per_iter.read(t) is None
    assert k1_roofline.read(t) is None
    no_pass = [e for e in EVENTS if "vecpass_" not in e[0]]
    assert pass_ms_per_iter.read(_trace(no_pass)) is None
    assert k1_ms_per_iter.read(_trace(no_pass)) == pytest.approx(2.5 / 4)
    assert k1_roofline.read(_trace(bound_s=None)) is None
    for reader in (k1_ms_per_iter, pass_ms_per_iter):
        assert reader.read(_trace(iterations=())) is None

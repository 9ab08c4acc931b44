"""``pass_kernels_per_iter`` on a synthetic trace: the vector passes'
kernels inside the ``bench.solve`` spans over the traced iterations, and
nothing where the program has no such kernel (a parent without them)."""

from benchmark import tracing
from benchmark.metrics import pass_kernels_per_iter

SPANS = [("bench.set_a", 0.0, 100.0), ("bench.solve", 110.0, 300.0),
         ("bench.solve", 400.0, 500.0)]
AXPAY = "void (anonymous namespace)::vecpass_axpay<double, 2, true>(double*)"
SUMS = "void (anonymous namespace)::vecpass_column_sums(double const*)"


def _trace(events, iterations=(3, 1)):
    return tracing.Trace(solves=[{"iterations": i} for i in iterations],
                         spans=SPANS, events=events)


def test_counts_the_passes_in_the_solves_over_their_iterations():
    events = [(AXPAY, 120.0, 121.0), (SUMS, 130.0, 131.0),
              ("pairpanel_spmm_mma_kernel", 140.0, 150.0),
              (AXPAY, 410.0, 411.0), (AXPAY, 50.0, 51.0),   # in set A
              ("Memcpy DtoD (Device -> Device)", 160.0, 161.0)]
    assert pass_kernels_per_iter.read(_trace(events)) == 3 / 4


def test_reads_nothing_without_the_kernels():
    events = [("void at::native::vectorized_elementwise_kernel", 120.0,
               121.0), ("pairpanel_spmm_mma_kernel", 140.0, 150.0)]
    assert pass_kernels_per_iter.read(_trace(events)) is None
    assert pass_kernels_per_iter.read(_trace([(AXPAY, 120.0, 121.0)],
                                             iterations=())) is None

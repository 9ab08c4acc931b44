"""k1_ms_per_iter: K1's device time inside the traced ``solve()`` calls
(the benchmark's ``bench.solve`` spans), over their iterations (ms): two
multiplies an iteration and one a probe.  Layer: the SpMM
(``csrc/pairpanel_spmm.cu``, K1).

Read only where the kernels the trace names K1's, over the whole traced
cycle, are as many as the card's own counter (``PairPlanMultiply.launches``)
counted over it, as ``k1_roofline`` reads: the profiler can misname a
graph's kernels, and a time read from misnamed events would be another
kernel's."""

from ..tracing import K1_KERNEL


def read(t):
    k1 = [name for name, _, _ in t.device_in_window() if K1_KERNEL in name]
    if not k1 or t.k1_launches != len(k1) or t.iterations == 0:
        return None
    ms = sum(b - a for name, a, b in t.in_spans("bench.solve")
             if K1_KERNEL in name) / 1e3
    return ms / t.iterations

"""k1_roofline: the share of K1's bound (``counts.bound_seconds``, the
benchmark's own count of one multiply) in K1's device time per launch from
the profiler (%).  Layer: the SpMM (``csrc/pairpanel_spmm.cu``, K1).

Read only where the kernels the trace names K1's are as many as the card's
own counter (``PairPlanMultiply.launches``) counted over the same span: the
profiler can misname a graph's kernels, and a time read from misnamed
events would be another kernel's."""

from ..tracing import K1_KERNEL


def read(t):
    k1 = [(a, b) for name, a, b in t.device_in_window() if K1_KERNEL in name]
    if not k1 or t.k1_bound_s is None or t.k1_launches != len(k1):
        return None
    per_launch_s = sum(b - a for a, b in k1) / len(k1) / 1e6
    return 100.0 * t.k1_bound_s / per_launch_s

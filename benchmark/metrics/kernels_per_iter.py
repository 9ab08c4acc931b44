"""kernels_per_iter: the device kernels (no copies, no fills) that ran
inside the traced ``solve()`` calls, over their iterations.  Layer: the
vector passes (``ops/linalg.py``); fusing them lowers it."""

from ..tracing import is_kernel


def read(t):
    n = sum(1 for name, _, _ in t.in_spans("bench.solve") if is_kernel(name))
    if n == 0 or t.iterations == 0:
        return None
    return n / t.iterations

"""pass_kernels_per_iter: the device kernels of the loop's vector passes
(``csrc/vector_passes.cu``, whose kernels' names start ``vecpass_``) that
ran inside the traced ``solve()`` calls, over their iterations.  Layer:
the vector passes (``ops/linalg.py``).  None where no such kernel ran (a
program without them)."""

PREFIX = "vecpass_"


def read(t):
    n = sum(1 for name, _, _ in t.in_spans("bench.solve") if PREFIX in name)
    if n == 0 or t.iterations == 0:
        return None
    return n / t.iterations

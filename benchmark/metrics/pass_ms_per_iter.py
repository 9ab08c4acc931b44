"""pass_ms_per_iter: the device time of the loop's vector passes
(``csrc/vector_passes.cu``, whose kernels' names start ``vecpass_``)
inside the traced ``solve()`` calls, over their iterations (ms).  Layer:
the vector passes (``ops/linalg.py``).  None where no such kernel ran (a
program without them)."""

from .pass_kernels_per_iter import PREFIX


def read(t):
    passes = [(a, b) for name, a, b in t.in_spans("bench.solve")
              if PREFIX in name]
    if not passes or t.iterations == 0:
        return None
    return sum(b - a for a, b in passes) / 1e3 / t.iterations

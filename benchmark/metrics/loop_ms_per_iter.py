"""loop_ms_per_iter: CUDA events recorded around each ``solve()`` of the
traced cycles, summed, over their iterations (ms).  Layer: the loop graph
(``graphloop.py``).  Nothing on a run without a card."""


def read(t):
    times = [s["loop_ms"] for s in t.solves]
    if not times or None in times or t.iterations == 0:
        return None
    return sum(times) / t.iterations

"""iters_per_solve: the mean of ``SolveInfo.iterations_needed`` over the
traced solves.  Layer: the iteration (``core.py``)."""


def read(t):
    if not t.solves:
        return None
    return t.iterations / len(t.solves)

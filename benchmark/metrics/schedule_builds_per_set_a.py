"""schedule_builds_per_set_a: the program's ``schedule`` spans (K1's tile
schedule built on the host, ``ops/pairpanel.tile_schedule``) over its
``tfq.set_a`` spans (``Solver.set_matrix('A')``) in the traced cycle.
Layer: the one-call API and Solver (``solver.py``, ``ops/pairpanel.py``);
a schedule kept with the plan takes it from 1 to 0."""

from .. import program_spans


def read(t):
    spans = program_spans.aligned(t)
    if not spans:
        return None
    sets = program_spans.calls(spans, "tfq.set_a")
    if not sets:
        return None
    return len(program_spans.within(spans, sets, "schedule")) / len(sets)

"""set_a_plan_pct: the wall of set A's plan-only work, the program's
``pair_table``, ``copies``, ``pair_y``, ``schedule`` and
``schedule_upload`` spans (what ``PairPlanMultiply`` rebuilds from the
plan alone), over the wall of its ``tfq.set_a`` spans in the traced cycle
(%).  Layer: the one-call API and Solver (``solver.py``,
``ops/pairpanel.py``)."""

from .. import program_spans

PLAN_ONLY = ("pair_table", "copies", "pair_y", "schedule", "schedule_upload")


def read(t):
    spans = program_spans.aligned(t)
    if not spans:
        return None
    sets = program_spans.calls(spans, "tfq.set_a")
    total = sum(s.end_us - s.start_us for s in sets.values())
    if total <= 0:
        return None
    plan = sum(s.end_us - s.start_us for s in spans
               if s.name in PLAN_ONLY and s.call in sets)
    return 100.0 * plan / total

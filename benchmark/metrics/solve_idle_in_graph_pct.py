"""solve_idle_in_graph_pct: of the time inside the program's traced
``tfq.solve.*`` spans in which no operation ran on the device, the share
that falls from the start of its ``launch`` span to the end of its
``read`` span, while the loop graph is in flight and the host waits on it
(%).  The rest is host work around the graph (``prepare``, ``fill``,
``finish``).  On the aligned clock (``program_spans``).  Layer: the loop
graph (``graphloop.py``)."""

from .. import program_spans


def read(t):
    spans = program_spans.aligned(t)
    if not spans or not t.events:
        return None
    solves = program_spans.calls(spans, "tfq.solve.")
    first = {}
    for name in ("launch", "read"):
        for s in program_spans.within(spans, solves, name):
            first.setdefault((s.call, name), s)
    total = inside = 0.0
    for i, s in solves.items():
        if (i, "launch") not in first or (i, "read") not in first:
            return None
        lo, hi = first[i, "launch"].start_us, first[i, "read"].end_us
        for a, b in program_spans.idle(t, s.start_us, s.end_us):
            total += b - a
            inside += max(0.0, min(b, hi) - max(a, lo))
    if total <= 0:
        return None
    return 100.0 * inside / total

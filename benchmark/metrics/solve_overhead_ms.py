"""solve_overhead_ms: the mean over the traced solves of the program's
``tfq.solve.*`` span less the loop graph's device time inside it
(``device_ms`` of its ``launch`` span): the solve call's time outside the
graph (ms).  Layer: the loop graph (``graphloop.py``)."""

from .. import program_spans


def read(t):
    spans = program_spans.aligned(t)
    if not spans:
        return None
    solves = program_spans.calls(spans, "tfq.solve.")
    graph = {}
    for s in program_spans.within(spans, solves, "launch"):
        if "device_ms" not in s.attrs:
            return None
        graph[s.call] = graph.get(s.call, 0.0) + s.attrs["device_ms"]
    if not solves or set(graph) != set(solves):
        return None
    return sum((s.end_us - s.start_us) / 1e3 - graph[i]
               for i, s in solves.items()) / len(solves)

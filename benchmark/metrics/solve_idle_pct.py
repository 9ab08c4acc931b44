"""solve_idle_pct: the share of the time inside the traced ``solve()``
calls (the benchmark's ``bench.solve`` spans, each closed by a synchronize)
in which no operation ran on the device: one minus the union of the
profiler's device intervals in those spans over their length (%).  Layer:
the loop graph (``graphloop.py``): its launch, the gaps between its nodes,
and the read of its final state."""


def read(t):
    spans = [(a, b) for name, a, b in t.spans if name == "bench.solve"]
    total = sum(b - a for a, b in spans)
    busy = t.busy(t.in_spans("bench.solve"))
    if total <= 0 or not busy:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in busy) / total)

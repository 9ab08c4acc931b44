"""graph_ms_per_iter: the loop graph's own device time, CUDA events that
the program records around its launch (``device_ms`` of each ``launch``
span, ``graphloop.LoopGraph.run``), summed over the traced solves, over
their iterations (ms).  The inside counterpart of ``loop_ms_per_iter``.
Layer: the loop graph (``graphloop.py``).  Nothing on a run without a
card, or where a traced solve has no such launch."""

from .. import program_spans


def read(t):
    spans = program_spans.aligned(t)
    if not spans or t.iterations == 0:
        return None
    solves = program_spans.calls(spans, "tfq.solve.")
    ms = [s.attrs.get("device_ms")
          for s in program_spans.within(spans, solves, "launch")]
    if len(ms) != len(t.solves) or None in ms:
        return None
    return sum(ms) / t.iterations

"""The program's own spans on a ``Trace``'s clock.

The port keeps its spans in memory while a ``torch.profiler`` session runs
(``tfqmrgpu_tpu_torch.profiling.spans()``: ``tfq.set_a``,
``tfq.solve.<engine>``, ``tfq.get_x`` and their children), on the
Unix-epoch clock of the profiler's own events, whose times the ``Trace``
holds relative to the session's start.  One offset maps the one onto the
other: the median of the start differences between each top-level program
span and the benchmark span around it (``bench.set_a``, ``bench.solve``,
``bench.get_x``).  The solves alone would not do: inside ``bench.solve``
the harness records a CUDA event before the call, which under the
profiler takes tens of microseconds, while the other two spans open
straight onto the call.  A program without the recorder, or a run that
recorded nothing, gives None, and the readers that take these spans give
None with it.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple, Optional

SLACK_US = 1000.0     # how far outside the benchmark's spans a kept one may lie


class ProgramSpan(NamedTuple):
    name: str
    start_us: float       # on the Trace's clock
    end_us: float
    id: int
    parent: int           # 0 at the top
    call: int             # the id of the top-level span of its call
    attrs: dict


def recorded() -> list:
    """The program's kept spans, or [] where the program keeps none."""
    try:
        from tfqmrgpu_tpu_torch import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


PAIRS = (("tfq.set_a", "bench.set_a"), ("tfq.solve.", "bench.solve"),
         ("tfq.get_x", "bench.get_x"))


def _differences(program: list, bench: list) -> list:
    """The start differences (us) of the run of ``len(bench)`` consecutive
    program spans whose differences spread least (there are more where
    the program recorded outside the traced cycle); [] where there are too
    few."""
    n = len(bench)
    best = None
    for k in range(len(program) - n + 1):
        d = [p - b for p, b in zip(program[k:k + n], bench)]
        if best is None or max(d) - min(d) < max(best) - min(best):
            best = d
    return best if n and best else []


def aligned(t) -> Optional[list]:
    """The program's spans inside the traced cycle, as ``ProgramSpan`` on
    ``t``'s clock, oldest start first; None where there are none or no
    offset can be found."""
    spans = recorded()
    d = []
    for prefix, bench in PAIRS:
        mine = sorted(s.start_ns / 1e3 for s in spans
                      if s.parent == 0 and s.name.startswith(prefix))
        theirs = sorted(a for n, a, _ in t.spans if n == bench)
        d += _differences(mine, theirs)
    if not d:
        return None
    off = statistics.median(d)
    lo, hi = t.window_us
    out = [ProgramSpan(s.name, s.start_ns / 1e3 - off, s.end_ns / 1e3 - off,
                       s.id, s.parent, s.call, dict(s.attrs))
           for s in spans]
    out = [s for s in out
           if s.start_us >= lo - SLACK_US and s.end_us <= hi + SLACK_US]
    return sorted(out, key=lambda s: s.start_us) or None


def calls(spans: list, prefix: str) -> dict:
    """The top-level spans whose name starts with ``prefix``, by id."""
    return {s.id: s for s in spans if s.parent == 0
            and s.name.startswith(prefix)}


def within(spans: list, tops: dict, name: str) -> list:
    """The spans named ``name`` inside the calls ``tops``."""
    return [s for s in spans if s.name == name and s.call in tops]


def idle(t, lo: float, hi: float) -> list:
    """The intervals of [lo, hi] (us) in which no device operation ran."""
    busy = t.busy([(n, max(a, lo), min(b, hi)) for n, a, b in t.events
                   if b > lo and a < hi])
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out

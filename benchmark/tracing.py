"""What a traced run keeps, and the reduction of the profiler's trace.

The benchmark records its own spans around the calls into each layer
(``bench.set_a``, ``bench.solve``, ``bench.get_x``: ``record_function``
ranges, closed by a synchronize where the call returns before the card is
done), CUDA events around each ``solve`` and the card's K1 launch counter
before and after; ``torch.profiler`` gives the device's operations.  The
per-layer readers in ``metrics/`` take what they need from a ``Trace``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

SPANS = ("bench.set_a", "bench.solve", "bench.get_x")
K1_KERNEL = "pairpanel_spmm_mma_kernel"


@dataclasses.dataclass
class Trace:
    solves: list                  # per traced solve: set_a_s, get_x_s,
    #                               iterations, probes, loop_ms
    spans: list                   # (name, start_us, end_us), host
    events: list                  # (name, start_us, end_us), device
    k1_launches: Optional[int] = None
    k1_bound_s: Optional[float] = None

    @property
    def window_us(self) -> tuple:
        if not self.spans:
            return (0.0, 0.0)
        return (min(s[1] for s in self.spans), max(s[2] for s in self.spans))

    @property
    def iterations(self) -> int:
        return sum(s["iterations"] for s in self.solves)

    def device_in_window(self) -> list:
        lo, hi = self.window_us
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.events
                if b > lo and a < hi]

    def in_spans(self, name: str) -> list:
        """The device's operations clipped to the host spans ``name`` (each
        such span ends with a synchronize, so what ran in it was its own)."""
        out = []
        for s, lo, hi in self.spans:
            if s == name:
                out += [(n, max(a, lo), min(b, hi)) for n, a, b in self.events
                        if b > lo and a < hi]
        return out

    def busy(self, events: Optional[list] = None) -> list:
        """The union of ``events`` (by default the device's operations in
        the window), as merged (start, end) intervals."""
        merged = []
        events = self.device_in_window() if events is None else events
        for _, a, b in sorted(events, key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def window_s(self) -> float:
        lo, hi = self.window_us
        return (hi - lo) / 1e6


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def from_profiler(prof) -> tuple:
    """(host spans, device events) of a ``torch.profiler`` session."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, events = [], []
    for e in prof.events():
        r = e.time_range
        if e.name in SPANS:
            # a range also shows on the device's timeline as an annotation
            if e.device_type != cuda:
                spans.append((e.name, float(r.start), float(r.end)))
        elif e.device_type == cuda:
            events.append((e.name, float(r.start), float(r.end)))
    return spans, events


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device's operations that took most time, and the longest idle
    gaps by the benchmark span the host was in."""
    by_name: dict = {}
    for n, a, b in t.device_in_window():
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = t.window_us
    edges = [lo] + [v for iv in t.busy() for v in iv] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            where = next((s[0].split(".")[-1] for s in t.spans
                          if s[1] <= mid <= s[2]), "between_calls")
            gaps.append([where, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps[:top]}

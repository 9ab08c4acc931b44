"""The launch counters of the port's kernels, kept on the card.

Every kernel entry of ``csrc/`` takes a pointer to a 64-bit counter, and
the kernel adds one to it from block 0's thread 0 whenever it runs
(``csrc/launch_count.cuh``).  So a counter says how often its kernel ran,
also where no wrapper saw the launch: a replay of the loop's CUDA graph
(``graphloop.py``) runs the captured kernels and their counters move with
them.  The counters of a device are one int64 tensor there, made on the
first launch and kept for the life of the process; a read synchronizes
the device and copies it once.  The sharded layer's collectives have
counters of their own in the same tensor, moved by ``tick``.

A wrapper class names its counters in ``_counters`` (attribute -> slot, or
a tuple of slots that the attribute sums) and takes ``CountedLaunches`` as
its metaclass, so that ``RowTileMultiply.launches`` reads the card's
counter and ``RowTileMultiply.launches = 0`` resets it.  Under
``uncounted()`` the wrappers hand their kernels a null counter: the loop
graph's warm-up launches are not counted so.  On a CPU tensor no kernel
runs and no counter moves.
"""

from __future__ import annotations

import contextlib

import torch

SLOTS = ("k1", "k2", "k2_split", "k3", "k3_split", "oz", "x_split",
         "loop_decide", "loop_settle", "loop_continue", "loop_decide_local",
         "loop_decide_finish", "loop_settle_local", "loop_settle_finish",
         "vec_axpay", "vec_add_rhs", "vec_partials", "vec_column_sums",
         # collectives of the sharded layer, counted by ``tick``
         "all_gather", "all_reduce", "neighbour_exchange")

_counts: dict = {}       # device index -> int64[len(SLOTS)] on that device
_uncounted = 0


def pointer(device: torch.device, slot: str):
    """The address of ``slot``'s counter on ``device`` (a CUDA device), for
    a kernel entry's ``count`` argument; None under ``uncounted()``."""
    if _uncounted:
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    t = _counts.get(index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch counters are made outside a capture")
        t = _counts[index] = torch.zeros(len(SLOTS), dtype=torch.int64,
                                         device=torch.device("cuda", index))
        torch.cuda.synchronize(index)
    return t.data_ptr() + t.element_size() * SLOTS.index(slot)


def tick(device: torch.device, slot: str):
    """Count one event of ``slot`` on ``device`` where the current stream
    is at (csrc/loop_control.cu's ``tfq_count``): the sharded layer ticks
    after each collective, so that a graph's replay counts its collectives
    as its kernels count themselves.  Nothing under ``uncounted()``."""
    count = pointer(device, slot)
    if count is None:
        return
    from ._build import load_kernels

    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load_kernels().tfq_count(stream, count)
    if rc != 0:
        raise RuntimeError(f"the count kernel of {slot!r} returned {rc}")


@contextlib.contextmanager
def uncounted():
    """Launches inside do not count (a null counter to every kernel)."""
    global _uncounted
    _uncounted += 1
    try:
        yield
    finally:
        _uncounted -= 1


def read() -> dict:
    """slot -> the launches counted on every device since its reset."""
    total = dict.fromkeys(SLOTS, 0)
    for index, t in _counts.items():
        torch.cuda.synchronize(index)
        for slot, n in zip(SLOTS, t.tolist()):
            total[slot] += n
    return total


def reset(slot: str):
    """Set ``slot``'s count to 0 on every device."""
    for index, t in _counts.items():
        torch.cuda.synchronize(index)
        t[SLOTS.index(slot)] = 0


class CountedLaunches(type):
    """The metaclass of a kernel wrapper: its ``_counters`` attributes read
    and reset counters of ``SLOTS`` on the card."""

    def __getattr__(cls, name):
        slots = _slots_of(cls, name)
        if slots is None:
            raise AttributeError(f"type object {cls.__name__!r} has no "
                                 f"attribute {name!r}")
        counts = read()
        return sum(counts[s] for s in slots)

    def __setattr__(cls, name, value):
        slots = _slots_of(cls, name)
        if slots is None:
            return super().__setattr__(name, value)
        if value != 0:
            raise ValueError(f"{cls.__name__}.{name} is a launch counter on "
                             f"the card: it can only be reset to 0")
        for s in slots:
            reset(s)


def _slots_of(cls, name: str):
    """The slots that ``cls``'s attribute ``name`` counts, or None."""
    for klass in cls.__mro__:
        slots = klass.__dict__.get("_counters", {}).get(name)
        if slots is not None:
            return (slots,) if isinstance(slots, str) else tuple(slots)
    return None

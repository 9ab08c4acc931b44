"""The graph driver of the tfQMR loop: the whole loop on the card.

The JAX package runs a solve as one ``jax.lax.while_loop`` with the probe
under ``jax.lax.cond`` (tfqmrgpu_tpu/core.py:157-227), so the host reads
back only the final state.  Here the same loop is one CUDA graph, launched
once a solve:

    init_carry                        (the state from the static inputs)
    continue                          (sets the WHILE node)
    WHILE {
        step                          (the half-steps, copied into the carry
                                       where not written there in place)
        decide                        (sets the IF node)
        IF { probe_residual, settle }
        continue                      (sets the WHILE node)
    }
    state = [stop_code, iters_needed, it, n_probes, residual2]

``step``, ``probe_residual`` and the carry are ``core``'s, in PyTorch and
the engine's kernels; ``decide``, ``settle`` and ``continue`` are the
kernels of ``csrc/loop_control.cu`` (``LoopControl``), since only device
code can set a conditional node.  The graph is captured on a stream of its
own (one a device for the process) into a private pool of PyTorch's
allocator: the capture of the stream
is ended and resumed around each conditional node
(``cudaStreamBeginCaptureToGraph``), so one stream serves it all.  Before
the capture one iteration and one probe run on a scratch carry, so that
every lazy set-up of the engine (the kernel build, occupancy queries, work
lists and tensor maps) happens outside it.  A capture that fails raises;
nothing falls back to the plain driver.

Each solve copies its inputs (B, v3, v5, tau0, inv_bn2, tol2, maxit) into
the graph's static buffers, launches the graph once, clones x, the status
and tau out of the pool (the next launch overwrites them) and reads the
state in one device-to-host copy.  ``LoopGraphs`` keeps a Solver's graphs;
a new A that the captured multiply takes in place (``refill``) keeps them.

A sharded solve (``parallel/``) is one such graph on every rank: its
halo exchanges and column sums are NCCL collectives captured in the WHILE
body, and ``decide`` and ``settle`` each become a local stage, one
captured ``all_reduce`` of the rank's partials over the mesh and a finish
stage that sets the node, so every rank takes each decision from the
same reduced scalars.  The ranks tell each other, through the process
group's store, whether their capture succeeded before any launches, so
that a failed capture raises on every rank rather than leaving the others
in a collective.  Such a graph holds NCCL's captured work until it is
closed: ``multihost.shutdown`` closes them all before it destroys the
process group (``close_sharded``).

A replay launches the kernels without their Python wrappers; the kernels
count their own launches on the card (``launch_counts``), so the counters
(``PairPlanMultiply.launches`` and the others) move with every replay.  The
warm-up's launches are not counted (``launch_counts.uncounted``) and the
capture launches nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import types
import weakref

import numpy as np
import torch

from . import core, launch_counts, profiling
from .errors import Status, TfqmrgpuError, encode_status

_P = ctypes.c_void_p
_U = ctypes.c_ulonglong

# conditional node kinds of tfq_loop_graph_open
IF, WHILE = 0, 1


def _check(rc: int, what: str):
    if rc != 0:
        raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                            f"{what} returned {rc}")


def _scalar(t: torch.Tensor, dtype, what: str):
    if t.dtype != dtype or t.dim() != 0:
        raise ValueError(f"{what} must be a 0-d {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _field(t: torch.Tensor, dtype, shape, what: str):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {shape} {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


class LoopControl(metaclass=launch_counts.CountedLaunches):
    """The wrappers of ``csrc/loop_control.cu``: the loop's decisions on the
    card.  Each acts in place on the carry's scalars and, inside a graph,
    sets a conditional node's ``handle``; it launches its kernel or raises.
    Their plain versions are ``core.decide``, ``core.settle`` and
    ``running``, and for a sharded solve's two stages ``core.decide_local``
    / ``decide_finish`` and ``core.settle_local`` / ``settle_finish``.
    ``launches`` reads every control kernel's launch counter on the card
    (``launch_counts``), the other attributes each one's."""

    _counters = {"launches": ("loop_decide", "loop_settle", "loop_continue",
                              "loop_decide_local", "loop_decide_finish",
                              "loop_settle_local", "loop_settle_finish"),
                 "decides": "loop_decide", "settles": "loop_settle",
                 "continues": "loop_continue",
                 "decide_locals": "loop_decide_local",
                 "decide_finishes": "loop_decide_finish",
                 "settle_locals": "loop_settle_local",
                 "settle_finishes": "loop_settle_finish"}

    @staticmethod
    def _lib():
        from ._build import load_kernels

        return load_kernels()

    @staticmethod
    def _checks(c: core.Carry, inv_bn2: torch.Tensor = None):
        shape = tuple(c.tau.shape)
        _field(c.tau, torch.float64, shape, "tau")
        _field(c.status, torch.int32, shape, "status")
        if inv_bn2 is not None:
            _field(inv_bn2, torch.float64, shape, "inv_bn2")
        for name in ("it", "stop_code", "iters_needed", "n_probes"):
            _scalar(getattr(c, name), torch.int32, name)
        for name in ("target_bound2", "residual2"):
            _scalar(getattr(c, name), torch.float64, name)
        if c.tau.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no loop control kernel for {c.tau.device}")

    @staticmethod
    def _run(entry: str, slot: str, dev: torch.device, *args):
        """Launch ``entry`` on the current stream with ``slot``'s counter."""
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(LoopControl._lib(), entry)(
                *args, stream, launch_counts.pointer(dev, slot))
        _check(rc, f"the loop's {slot} kernel")

    @staticmethod
    def decide(c: core.Carry, inv_bn2: torch.Tensor, maxit: torch.Tensor,
               max_bound2: torch.Tensor, probe: torch.Tensor,
               handle: int = None):
        """``core.decide`` into c.stop_code, ``max_bound2`` (float64) and
        ``probe`` (int32), 0-d; ``handle`` gets the probe predicate."""
        LoopControl._checks(c, inv_bn2)
        _scalar(maxit, torch.int32, "maxit")
        _scalar(max_bound2, torch.float64, "max_bound2")
        _scalar(probe, torch.int32, "probe")
        LoopControl._run(
            "tfq_loop_decide", "loop_decide", c.tau.device,
            c.tau.data_ptr(), inv_bn2.data_ptr(), c.status.data_ptr(),
            c.tau.numel(), c.it.data_ptr(), maxit.data_ptr(),
            c.target_bound2.data_ptr(), c.stop_code.data_ptr(),
            max_bound2.data_ptr(), probe.data_ptr(), handle or 0,
            int(handle is not None))

    @staticmethod
    def settle(c: core.Carry, res2: torch.Tensor, max_bound2: torch.Tensor,
               tol2: torch.Tensor):
        """``core.settle`` into the carry's status and scalars."""
        LoopControl._checks(c)
        _field(res2, torch.float64, tuple(c.tau.shape), "res2")
        _scalar(max_bound2, torch.float64, "max_bound2")
        _scalar(tol2, torch.float64, "tol2")
        LoopControl._run(
            "tfq_loop_settle", "loop_settle", c.tau.device,
            res2.data_ptr(), c.status.data_ptr(), c.tau.numel(),
            tol2.data_ptr(), max_bound2.data_ptr(), c.it.data_ptr(),
            c.residual2.data_ptr(), c.target_bound2.data_ptr(),
            c.stop_code.data_ptr(), c.iters_needed.data_ptr(),
            c.n_probes.data_ptr())

    @staticmethod
    def decide_local(c: core.Carry, inv_bn2: torch.Tensor,
                     part: torch.Tensor, keep_nan: bool):
        """``core.decide_local`` into ``part`` (float64[2])."""
        LoopControl._checks(c, inv_bn2)
        _field(part, torch.float64, (2,), "part")
        LoopControl._run(
            "tfq_loop_decide_local", "loop_decide_local", c.tau.device,
            c.tau.data_ptr(), inv_bn2.data_ptr(), c.status.data_ptr(),
            c.tau.numel(), int(keep_nan), part.data_ptr())

    @staticmethod
    def decide_finish(c: core.Carry, part: torch.Tensor, maxit: torch.Tensor,
                      max_bound2: torch.Tensor, probe: torch.Tensor,
                      handle: int = None):
        """``core.decide_finish`` from the reduced ``part``, into
        c.stop_code, ``max_bound2`` and ``probe``; ``handle`` gets the probe
        predicate."""
        LoopControl._checks(c)
        _field(part, torch.float64, (2,), "part")
        _scalar(maxit, torch.int32, "maxit")
        _scalar(max_bound2, torch.float64, "max_bound2")
        _scalar(probe, torch.int32, "probe")
        LoopControl._run(
            "tfq_loop_decide_finish", "loop_decide_finish", c.tau.device,
            part.data_ptr(), c.it.data_ptr(), maxit.data_ptr(),
            c.target_bound2.data_ptr(), c.stop_code.data_ptr(),
            max_bound2.data_ptr(), probe.data_ptr(), handle or 0,
            int(handle is not None))

    @staticmethod
    def settle_local(c: core.Carry, res2: torch.Tensor, tol2: torch.Tensor,
                     part: torch.Tensor, keep_nan: bool):
        """``core.settle_local``: the status update in place, the partials
        into ``part`` (float64[2])."""
        LoopControl._checks(c)
        _field(res2, torch.float64, tuple(c.tau.shape), "res2")
        _scalar(tol2, torch.float64, "tol2")
        _field(part, torch.float64, (2,), "part")
        LoopControl._run(
            "tfq_loop_settle_local", "loop_settle_local", c.tau.device,
            res2.data_ptr(), c.status.data_ptr(), c.tau.numel(),
            tol2.data_ptr(), int(keep_nan), part.data_ptr())

    @staticmethod
    def settle_finish(c: core.Carry, part: torch.Tensor,
                      max_bound2: torch.Tensor, tol2: torch.Tensor):
        """``core.settle_finish`` from the reduced ``part`` into the
        carry's scalars."""
        LoopControl._checks(c)
        _field(part, torch.float64, (2,), "part")
        _scalar(max_bound2, torch.float64, "max_bound2")
        _scalar(tol2, torch.float64, "tol2")
        LoopControl._run(
            "tfq_loop_settle_finish", "loop_settle_finish", c.tau.device,
            part.data_ptr(), tol2.data_ptr(), max_bound2.data_ptr(),
            c.it.data_ptr(), c.residual2.data_ptr(),
            c.target_bound2.data_ptr(), c.stop_code.data_ptr(),
            c.iters_needed.data_ptr(), c.n_probes.data_ptr())

    @staticmethod
    def running(c: core.Carry, maxit: torch.Tensor) -> torch.Tensor:
        """The plain version of ``cont``: it < maxit and stop_code == 0."""
        return (c.it < maxit) & (c.stop_code == 0)

    @staticmethod
    def cont(c: core.Carry, maxit: torch.Tensor, go: torch.Tensor = None,
             handle: int = None):
        """Whether the loop goes on, into ``go`` (int32, 0-d) where given
        and into ``handle``."""
        LoopControl._checks(c)
        _scalar(maxit, torch.int32, "maxit")
        if go is not None:
            _scalar(go, torch.int32, "go")
        LoopControl._run(
            "tfq_loop_continue", "loop_continue", c.tau.device,
            c.it.data_ptr(), maxit.data_ptr(), c.stop_code.data_ptr(),
            None if go is None else go.data_ptr(), handle or 0,
            int(handle is not None))


@dataclasses.dataclass
class LoopInputs:
    """The loop's inputs: a solve's, or a graph's static buffers."""

    v2: object                  # B (unit blocks when the RHS is trivial)
    v3: object                  # the shadow vector
    v5_init: object             # B in X's shape
    tau0: torch.Tensor          # f64[ncols, LN]
    inv_bn2: torch.Tensor       # f64[ncols, LN]
    tol2: torch.Tensor          # f64, 0-d
    maxit: torch.Tensor         # int32, 0-d

    def values(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def buffers(self) -> "LoopInputs":
        """Static buffers of the same shapes, types and device."""
        def empty(t):
            return torch.empty_like(t, memory_format=torch.contiguous_format)

        return LoopInputs(*(core._tree(empty, v) for v in self.values()))

    def fill(self, other: "LoopInputs"):
        """Copy ``other``'s values into these buffers."""
        for mine, theirs in zip(self.values(), other.values()):
            for m, t in zip(_leaves(mine), _leaves(theirs)):
                m.copy_(t)


class GraphCapture:
    """The loop's graph, made from the capture of ``stream``
    (``csrc/loop_control.cu``'s tfq_loop_graph_* calls)."""

    def __init__(self, lib, stream: torch.cuda.Stream):
        self.lib, self.stream = lib, stream.cuda_stream
        g = _P()
        _check(lib.tfq_loop_graph_begin(self.stream, ctypes.byref(g)),
               "the graph's capture")
        self.graph = g.value
        self.graphs = [g.value]          # the graph being captured, innermost
        self.bodies = []                 # every conditional node's body

    def handle(self) -> int:
        h = _U()
        _check(self.lib.tfq_loop_graph_handle(self.stream, ctypes.byref(h)),
               "a conditional handle")
        return h.value

    @contextlib.contextmanager
    def node(self, handle: int, kind: int):
        node, body = _P(), _P()
        _check(self.lib.tfq_loop_graph_open(self.stream, handle, kind,
                                            ctypes.byref(node),
                                            ctypes.byref(body)),
               "a conditional node")
        self.graphs.append(body.value)
        self.bodies.append(body.value)
        yield
        self.graphs.pop()
        _check(self.lib.tfq_loop_graph_close(self.stream, self.graphs[-1],
                                             node.value),
               "the capture after a conditional node")

    def end(self) -> int:
        ex = _P()
        why = (ctypes.c_int * 2)()
        rc = self.lib.tfq_loop_graph_end(self.stream, self.graph,
                                         ctypes.byref(ex), why)
        # an event wait or record node in a body: NCCL's, under graph mixing
        hint = ("; a conditional body holds no event node: NCCL adds them "
                "unless NCCL_GRAPH_MIXING_SUPPORT=0 was set before its first "
                "communicator" if why[1] in (6, 7) else "")
        _check(rc, f"the graph's instantiation (cudaGraphInstantiateResult "
                   f"{why[0]}, node type {why[1]} at fault{hint})")
        return ex.value

    def abort(self):
        """End a failed capture.  The graph is left to the driver: an
        invalidated capture into a conditional node's body leaves that body
        in a state the graph's destruction does not survive."""
        self.lib.tfq_loop_graph_abort(self.stream)


def record(prim: core.TfqmrPrimitives, ins: LoopInputs, dt,
           capture) -> tuple:
    """The loop, as the graph holds it, recorded through ``capture`` (a
    ``GraphCapture``: ``handle()`` makes a conditional handle and
    ``node(handle, kind)`` captures its block into a conditional node):
    returns (carry, state), the carry and the final scalars [stop_code,
    iters_needed, it, n_probes, residual2] (float64) that the graph
    writes."""
    dev = ins.tau0.device
    c = core.init_carry(ins.v5_init, ins.tau0, ins.tol2, ins.maxit, dt)
    max_bound2 = torch.zeros((), dtype=torch.float64, device=dev)
    probe = torch.zeros((), dtype=torch.int32, device=dev)
    w = capture.handle()
    LoopControl.cont(c, ins.maxit, handle=w)
    with capture.node(w, WHILE):
        n = core.step(prim, c, ins.v3, dt)
        # a result written into the carry in place is its own source, and
        # copy_ launches nothing for it
        for f in ("it", "v1", "v4", "v5", "v6", "v7", "v8", "rho", "eta",
                  "tau", "var", "status"):
            for mine, new in zip(*(_leaves(getattr(x, f)) for x in (c, n))):
                mine.copy_(new)
        i = capture.handle()
        decide(prim, c, ins, max_bound2, probe, handle=i)
        with capture.node(i, IF):
            res2 = core.probe_residual(prim, c, ins.v2, ins.inv_bn2)
            settle(prim, c, res2, max_bound2, ins.tol2)
        LoopControl.cont(c, ins.maxit, handle=w)
    state = torch.stack([c.stop_code.to(torch.float64),
                         c.iters_needed.to(torch.float64),
                         c.it.to(torch.float64),
                         c.n_probes.to(torch.float64), c.residual2])
    return c, state


def decide(prim: core.TfqmrPrimitives, c: core.Carry, ins: LoopInputs,
           max_bound2: torch.Tensor, probe: torch.Tensor, handle=None):
    """The graph's decision after an iteration: ``LoopControl.decide``, or
    on a mesh (``prim.mesh``) its local stage, the all_reduce of the
    partials over every rank and its finish stage."""
    mesh = prim.mesh
    if mesh is None:
        LoopControl.decide(c, ins.inv_bn2, ins.maxit, max_bound2, probe,
                           handle=handle)
        return
    part = torch.empty(2, dtype=torch.float64, device=c.tau.device)
    LoopControl.decide_local(c, ins.inv_bn2, part, mesh.ranks == 1)
    mesh.reduce_max(part)
    LoopControl.decide_finish(c, part, ins.maxit, max_bound2, probe,
                              handle=handle)


def settle(prim: core.TfqmrPrimitives, c: core.Carry, res2: torch.Tensor,
           max_bound2: torch.Tensor, tol2: torch.Tensor):
    """The graph's decision after a probe: ``LoopControl.settle``, or on a
    mesh its two stages around the all_reduce of the partials."""
    mesh = prim.mesh
    if mesh is None:
        LoopControl.settle(c, res2, max_bound2, tol2)
        return
    part = torch.empty(2, dtype=torch.float64, device=c.tau.device)
    LoopControl.settle_local(c, res2, tol2, part, mesh.ranks == 1)
    mesh.reduce_max(part)
    LoopControl.settle_finish(c, part, max_bound2, tol2)


def _leaves(v) -> tuple:
    return (v,) if torch.is_tensor(v) else tuple(v)


_streams: dict = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream that warms up and captures every loop graph of ``dev``:
    one for the process, so that the allocator's blocks cached for it
    serve the next graph's warm-up."""
    s = _streams.get(dev.index)
    if s is None:
        s = _streams[dev.index] = torch.cuda.Stream(dev)
    return s


def _pool_calls():
    """(begin, end) of routing the current stream's allocations to a
    private pool of PyTorch's caching allocator."""
    c = torch._C
    begin = c._cuda_beginAllocateCurrentStreamToPool
    end = getattr(c, "_cuda_endAllocateToPool", None) or getattr(
        c, "_cuda_endAllocateCurrentStreamToPool")
    return begin, end


class LoopGraph:
    """One instantiated loop graph for a primitive set and input shapes.

    ``captures``, ``launches`` and ``reads`` count the captures, the graph
    launches and the state reads of every graph in this process, and
    ``capture_seconds`` sums the captures' host time (warm-up, capture and
    instantiation); ``capture_s`` is this graph's, ``capture_parts`` the
    same by part (seconds of 'warmup', 'record', 'instantiate')."""

    captures: int = 0
    capture_seconds: float = 0.0
    launches: int = 0
    reads: int = 0

    def __init__(self, prim: core.TfqmrPrimitives, ins: LoopInputs, dt):
        from ._build import load_kernels

        self.device = ins.tau0.device
        if self.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no loop graph for {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.prim, self.dt = prim, dt
        if prim.mesh is not None:
            _sharded.add(self)
        self.lib = load_kernels()
        self.inputs = ins.buffers()
        self.inputs.fill(ins)
        self.exec = self.graph = self.pool = None
        self.capture_s = float("nan")
        self.capture_parts: dict = {}
        self._capture()

    def _capture(self):
        # no collection during the capture: a dead graph's teardown is no
        # business of the stream being captured
        gc_on = gc.isenabled()
        gc.disable()
        try:
            self._capture_graph()
        finally:
            if gc_on:
                gc.enable()

    def _capture_graph(self):
        dev, ins = self.device, self.inputs
        t0 = profiling.clock()
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        capture = None
        begin_pool, end_pool = _pool_calls()
        launch_counts.pointer(dev, launch_counts.SLOTS[0])  # made outside
        try:
            with torch.cuda.device(dev), torch.cuda.stream(stream), \
                    launch_counts.uncounted():
                # the warm-up: every lazy set-up before the capture
                c = core.init_carry(ins.v5_init, ins.tau0, ins.tol2,
                                    ins.maxit, self.dt)
                c = core.step(self.prim, c, ins.v3, self.dt)
                scratch = (torch.zeros((), dtype=torch.float64, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev))
                decide(self.prim, c, ins, *scratch)
                res2 = core.probe_residual(self.prim, c, ins.v2, ins.inv_bn2)
                settle(self.prim, c, res2, scratch[0], ins.tol2)
                LoopControl.cont(c, ins.maxit, scratch[1])
                del c, res2, scratch
            stream.synchronize()
            t1 = profiling.clock()
            self.pool = torch.cuda.graph_pool_handle()
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                begin_pool(dev.index, self.pool)
                try:
                    capture = GraphCapture(self.lib, stream)
                    self.carry, self.state = record(self.prim, ins, self.dt,
                                                    capture)
                    t2 = profiling.clock()
                    self.exec = capture.end()
                    self.graph = capture.graph
                finally:
                    end_pool(dev.index, self.pool)
        except BaseException:
            if capture is not None and self.exec is None:
                capture.abort()
            self.close()
            if self.prim.mesh is not None:
                self.prim.mesh.agree(False)
            raise
        if self.prim.mesh is not None and not self.prim.mesh.agree(True):
            # no rank launches a graph whose collectives another rank lacks
            self.close()
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                "the loop graph's capture failed on another "
                                "rank of the mesh")
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        t3 = profiling.clock()
        self.capture_s = (t3 - t0) / 1e9
        parts = (("warmup", t0, t1), ("record", t1, t2),
                 ("instantiate", t2, t3))
        self.capture_parts = {k: (b - a) / 1e9 for k, a, b in parts}
        span = profiling.add_span("capture", t0, t3)
        if span is not None:
            for k, a, b in parts:
                profiling.add_span(k, a, b, parent=span)
        LoopGraph.captures += 1
        LoopGraph.capture_seconds += self.capture_s

    def run(self, ins: LoopInputs) -> core.SolveResult:
        """One solve: the inputs into the static buffers, one launch, one
        read of the state.  While spans are recorded, a CUDA event pair
        around the launch gives its ``launch`` span the graph's device time
        (``device_ms``), read after the state read has synchronized."""
        if self.exec is None:
            raise RuntimeError("the loop graph was closed")
        with profiling.trace("fill"):
            self.inputs.fill(ins)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            with profiling.trace("launch") as launch:
                if launch is not None:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                _check(self.lib.tfq_loop_graph_launch(self.exec, stream),
                       "the loop graph's launch")
                if launch is not None:
                    ev[1].record()
            LoopGraph.launches += 1
            with profiling.trace("read"):
                c = self.carry
                out = dataclasses.replace(
                    c, v1=core._tree(torch.clone, c.v1),
                    status=c.status.clone(), tau=c.tau.clone())
                stop, iters_needed, it, n_probes, residual2 = \
                    self.state.tolist()
        LoopGraph.reads += 1
        if launch is not None:
            launch.attrs["device_ms"] = ev[0].elapsed_time(ev[1])
        return core.solve_result(out, stop, iters_needed, n_probes, residual2)

    def close(self):
        """Destroy the graph and give its pool back."""
        if self.exec is not None or self.graph is not None:
            self.lib.tfq_loop_graph_destroy(self.exec, self.graph)
        self.exec = self.graph = None
        self.carry = self.state = None
        if self.pool is not None:
            # the pool's blocks go back to the driver only in a later
            # empty_cache, which synchronizes first
            torch._C._cuda_releasePool(self.device.index, self.pool)
            self.pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter shutdown: nothing to give back
            pass


_sharded = weakref.WeakSet()        # the live loop graphs of sharded solves


def close_sharded():
    """Close every live loop graph of a sharded solve in this process
    (``multihost.shutdown``: NCCL destroys no communicator whose captured
    work a graph still holds; a graph still running is freed when it
    ends).  Their solvers keep them closed: a later solve raises."""
    for g in list(_sharded):
        g.close()
    _sharded.clear()


class LoopGraphs:
    """A Solver's loop graphs, one for each of its solve entries (``key``:
    the engine's layout and ``rhs_trivial``) and input shapes.  The Solver
    drops them when v3 changes, and when A changes in a way that its
    multiply cannot take in place (``Solver.set_matrix``)."""

    def __init__(self):
        self._graphs: dict = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def get(self, key: tuple, prim, ins: LoopInputs, dt) -> LoopGraph:
        sig = tuple((tuple(t.shape), t.dtype) for f in ins.values()
                    for t in _leaves(f))
        k = (key, sig, dt)
        g = self._graphs.get(k)
        if g is None:
            g = self._graphs[k] = LoopGraph(prim, ins, dt)
        return g

    def clear(self):
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()


def refill(old, new) -> bool:
    """Write ``new``'s values into ``old``, two multiplies built by the same
    engine over the same plan from different values of A, so that graphs
    that captured ``old`` compute with ``new``'s A.  Only where they are
    the same but for their floating-point tensors: the same types, numbers,
    strings, host arrays and integer tensors (the tables), and tensors of
    the same shapes, strides and types.  A part that ``old`` made on its
    first call and ``new`` has not made yet (None, or an empty container,
    in ``new``) stays ``old``'s: it depends on the plan and on ``old``'s own
    buffers.  Returns False, and leaves ``old`` as it was, where they
    differ otherwise, or hold what cannot be compared (a host buffer, a
    function's code)."""
    pairs: list = []
    if not _same_but_values(old, new, pairs, set()):
        return False
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
    return True


_ATOMS = (int, float, complex, str, bytes, bool, type(None), np.generic,
          torch.dtype, torch.device)


def _same_but_values(old, new, pairs: list, seen: set) -> bool:
    if old is new:
        return True
    if (id(old), id(new)) in seen:
        return True
    seen.add((id(old), id(new)))
    if new is None or (type(new) in (tuple, list, dict) and not new
                       and type(old) is type(new)):
        return True                         # a part old made lazily
    if torch.is_tensor(old) or torch.is_tensor(new):
        if not (torch.is_tensor(old) and torch.is_tensor(new)) or (
                old.shape, old.stride(), old.dtype, old.device) != (
                new.shape, new.stride(), new.dtype, new.device):
            return False
        if old.is_floating_point() or old.is_complex():
            pairs.append((old, new))
            return True
        return bool(torch.equal(old, new))
    if type(old) is not type(new):
        return False
    if isinstance(old, np.ndarray):
        return (old.shape == new.shape and old.dtype == new.dtype
                and bool(np.array_equal(old, new)))
    if isinstance(old, _ATOMS):
        return old == new
    if isinstance(old, (tuple, list)):
        return len(old) == len(new) and all(
            _same_but_values(a, b, pairs, seen) for a, b in zip(old, new))
    if isinstance(old, dict):
        return old.keys() == new.keys() and all(
            _same_but_values(old[k], new[k], pairs, seen) for k in old)
    if isinstance(old, types.FunctionType):
        cells = [tuple(c.cell_contents for c in f.__closure__ or ())
                 for f in (old, new)]
        return (old.__code__ is new.__code__
                and _same_but_values(old.__defaults__, new.__defaults__,
                                     pairs, seen)
                and _same_but_values(*cells, pairs, seen))
    if isinstance(old, functools.partial):
        return _same_but_values((old.func, old.args, old.keywords),
                                (new.func, new.args, new.keywords), pairs,
                                seen)
    if hasattr(old, "__dict__") and not isinstance(old, type):
        return _same_but_values(vars(old), vars(new), pairs, seen)
    return False


def run_graph(graphs, key: tuple, prim, v2, v3, v5_init, tau0, inv_bn2,
              tol2: float, maxit: int, dt) -> core.SolveResult:
    """``core.tfqmr_loop`` on a CUDA device: the graph of ``graphs`` under
    ``key`` (captured on its first solve), or, without ``graphs``, a graph
    for this solve alone."""
    dev = tau0.device
    ins = LoopInputs(v2=v2, v3=v3, v5_init=v5_init, tau0=tau0,
                     inv_bn2=inv_bn2,
                     tol2=torch.full((), tol2, dtype=torch.float64,
                                     device=dev),
                     maxit=torch.full((), maxit, dtype=torch.int32,
                                      device=dev))
    if graphs is not None:
        return graphs.get(key, prim, ins, dt).run(ins)
    g = LoopGraph(prim, ins, dt)
    try:
        return g.run(ins)
    finally:
        g.close()

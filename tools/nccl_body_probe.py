"""Whether NCCL's collectives can run inside a conditional node's body.

    NCCL_DEBUG=INFO torchrun --standalone --nproc_per_node=N \\
        tools/nccl_body_probe.py

The sharded loop graph puts the collectives of an iteration (the halo
``all_gather``, the ``all_reduce`` of the column sums and of the
convergence decision, the edge exchange) inside the body of a WHILE node
(``graphloop.py``).  A conditional node's body holds only kernel, memcpy,
memset, empty, child-graph and conditional nodes; NCCL and
``ProcessGroupNCCL`` under stream capture may add others (a host node for
proxy work, event nodes, a user object retained on the captured graph).

This probe captures each kind of collective, through the port's own
``tfq_loop_graph_*`` calls (``graphloop.GraphCapture``, the capture stream
and the private pool of the loop graph), into a WHILE body that runs 3
times, launches the graph once and checks the results against the same
collectives run eagerly (integer-valued float64, so that any order of the
sums gives the same bits), by two routes:

* ``torch.distributed``: ``ProcessGroupNCCL``'s ``all_reduce`` (SUM and
  MAX of float64), ``all_gather_into_tensor`` (blocking, and asynchronous
  with ``wait()`` in the body, as the sharded packed pairs issue it) and a
  ``batch_isend_irecv`` ring (the edge exchange);
* ``nccl``: the same collectives called in NCCL itself (``ncclAllReduce``,
  ``ncclAllGather``, ``ncclSend``/``ncclRecv`` in a group) on the capture
  stream, and an ``ncclAllGather`` on a side stream forked from the capture
  stream and joined back.

Each case has a communicator of its own, made and warmed up (with its eager
reference) before any capture, so that a refused capture cannot hold the
next case.  For each case rank 0 prints PASS or FAIL, the census of the
WHILE body's nodes by type (and each kernel node's cluster width and
memory synchronization domain) and, where the instantiation refused, the
cudaGraphInstantiateResult and the type of the node at fault.  The ranks
agree through the process group's store, never through a collective after
a capture; the process ends itself after 150 s.  NCCL's transport lines
come from ``NCCL_DEBUG=INFO`` on the command line.  Needs two or more
cards.
"""

from __future__ import annotations

import ctypes
import faulthandler
import glob
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tfqmrgpu_tpu_torch import graphloop  # noqa: E402
from tfqmrgpu_tpu_torch._build import load_kernels  # noqa: E402

ITERATIONS = 3
N = 1000
LAUNCH_LIMIT_S = 30.0
# CUgraphNodeType, in order
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_signal", "ext_wait",
              "mem_alloc", "mem_free", "batch_mem_op", "conditional")
CLUSTER_DIMENSION, MEM_SYNC_DOMAIN = 4, 10      # CUlaunchAttributeID
F64, SUM, MAX = 8, 0, 2          # ncclFloat64, ncclSum, ncclMax


class UniqueId(ctypes.Structure):
    _fields_ = [("internal", ctypes.c_char * 128)]


def libnccl() -> ctypes.CDLL:
    """The NCCL that torch loaded (by its soname), else the one of the
    ``nvidia-nccl`` wheel beside torch."""
    try:
        lib = ctypes.CDLL("libnccl.so.2")
    except OSError:
        site = os.path.dirname(os.path.dirname(torch.__file__))
        lib = ctypes.CDLL(glob.glob(os.path.join(
            site, "nvidia", "nccl", "lib", "libnccl.so*"))[0])
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.ncclCommInitRank.argtypes = [ctypes.POINTER(P), I, UniqueId, I]
    lib.ncclAllReduce.argtypes = [P, P, S, I, I, P, P]
    lib.ncclAllGather.argtypes = [P, P, S, I, P, P]
    lib.ncclSend.argtypes = [P, S, I, I, P, P]
    lib.ncclRecv.argtypes = [P, S, I, I, P, P]
    lib.ncclGetErrorString.argtypes = [I]
    lib.ncclGetErrorString.restype = ctypes.c_char_p
    return lib


class Nccl:
    """One NCCL communicator over every rank, its id passed through the
    process group's store under ``tag``."""

    def __init__(self, lib, store, tag: str, rank: int, world: int):
        self.lib = lib
        uid = UniqueId()
        if rank == 0:
            self.ok(lib.ncclGetUniqueId(ctypes.byref(uid)))
            store.set(tag, ctypes.string_at(ctypes.addressof(uid), 128))
        else:
            uid = UniqueId.from_buffer_copy(store.get(tag))
        self.comm = ctypes.c_void_p()
        self.ok(lib.ncclCommInitRank(ctypes.byref(self.comm), world, uid,
                                     rank))

    def ok(self, rc: int):
        if rc != 0:
            raise RuntimeError(f"NCCL error {rc}: "
                               f"{self.lib.ncclGetErrorString(rc).decode()}")

    def stream(self) -> int:
        return torch.cuda.current_stream().cuda_stream

    def all_reduce(self, t: torch.Tensor, op: int):
        self.ok(self.lib.ncclAllReduce(t.data_ptr(), t.data_ptr(), t.numel(),
                                       F64, op, self.comm, self.stream()))

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        self.ok(self.lib.ncclAllGather(inp.data_ptr(), out.data_ptr(),
                                       inp.numel(), F64, self.comm,
                                       self.stream()))

    def ring(self, send, recv, to: int, frm: int):
        lib = self.lib
        self.ok(lib.ncclGroupStart())
        self.ok(lib.ncclSend(send.data_ptr(), send.numel(), F64, to,
                             self.comm, self.stream()))
        self.ok(lib.ncclRecv(recv.data_ptr(), recv.numel(), F64, frm,
                             self.comm, self.stream()))
        self.ok(lib.ncclGroupEnd())


def make_cases(rank: int, world: int, dev, store) -> list:
    """(name, body maker): a maker returns (accumulators, body(k))."""
    f64 = torch.float64
    x = torch.arange(N, dtype=f64, device=dev) + 1000.0 * rank
    to, frm = (rank + 1) % world, (rank - 1) % world
    lib = libnccl()

    def buf(n=N):
        return torch.zeros(n, dtype=f64, device=dev)

    def scaled(k, out):
        torch.mul(x, (k + 1).to(f64), out=out)

    def td_all_reduce(op):
        g = dist.new_group(list(range(world)))

        def make():
            red, acc = buf(), buf()

            def body(k):
                scaled(k, red)
                dist.all_reduce(red, op=op, group=g)
                acc.add_(red)
            return [acc], body
        return make

    def td_all_gather(async_op):
        g = dist.new_group(list(range(world)))

        def make():
            src, out, acc = buf(), buf(world * N), buf(world * N)

            def body(k):
                scaled(k, src)
                w = dist.all_gather_into_tensor(out, src, group=g,
                                                async_op=async_op)
                if async_op:
                    acc.mul_(1.0)        # work on this stream meanwhile
                    w.wait()
                acc.add_(out)
            return [acc], body
        return make

    def td_ring():
        g = dist.new_group(list(range(world)))

        def make():
            send, recv, acc = buf(), buf(), buf()

            def body(k):
                scaled(k, send)
                for w in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, send, to, g),
                         dist.P2POp(dist.irecv, recv, frm, g)]):
                    w.wait()
                acc.add_(recv)
            return [acc], body
        return make

    def nc_all_reduce(tag, op):
        c = Nccl(lib, store, tag, rank, world)

        def make():
            red, acc = buf(), buf()

            def body(k):
                scaled(k, red)
                c.all_reduce(red, op)
                acc.add_(red)
            return [acc], body
        return make

    def nc_all_gather(tag, side: bool):
        c = Nccl(lib, store, tag, rank, world)

        def make():
            src, out, acc = buf(), buf(world * N), buf(world * N)
            s2 = torch.cuda.Stream(dev)

            def body(k):
                scaled(k, src)
                if side:
                    s2.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(s2):
                        c.all_gather(out, src)
                    acc.mul_(1.0)
                    torch.cuda.current_stream().wait_stream(s2)
                else:
                    c.all_gather(out, src)
                acc.add_(out)
            return [acc], body
        return make

    def nc_ring(tag):
        c = Nccl(lib, store, tag, rank, world)

        def make():
            send, recv, acc = buf(), buf(), buf()

            def body(k):
                scaled(k, send)
                c.ring(send, recv, to, frm)
                acc.add_(recv)
            return [acc], body
        return make

    return [
        ("torch.distributed all_reduce SUM f64",
         td_all_reduce(dist.ReduceOp.SUM)),
        ("torch.distributed all_reduce MAX f64",
         td_all_reduce(dist.ReduceOp.MAX)),
        ("torch.distributed all_gather_into_tensor", td_all_gather(False)),
        ("torch.distributed all_gather_into_tensor async + wait",
         td_all_gather(True)),
        ("torch.distributed batch_isend_irecv ring", td_ring()),
        ("nccl ncclAllReduce SUM f64", nc_all_reduce("p0", SUM)),
        ("nccl ncclAllReduce MAX f64", nc_all_reduce("p1", MAX)),
        ("nccl ncclAllGather", nc_all_gather("p2", False)),
        ("nccl ncclAllGather on a side stream, joined",
         nc_all_gather("p3", True)),
        ("nccl ncclSend/ncclRecv ring in a group", nc_ring("p4")),
    ]


def libcuda() -> ctypes.CDLL:
    """The CUDA driver, with the argument types of the calls ``census``
    makes."""
    cu = ctypes.CDLL("libcuda.so.1")
    p = ctypes.c_void_p
    cu.cuGraphGetNodes.argtypes = [p, p, ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphKernelNodeGetAttribute.argtypes = [p, ctypes.c_int, p]
    return cu


def census(body) -> str:
    """The nodes of the graph ``body`` (not of the graphs inside its nodes)
    by type, and each kernel node's cluster x extent and memory
    synchronization domain (-1 where the driver gives none)."""
    cu = libcuda()
    n = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(body, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if rc == 0:
        rc = cu.cuGraphGetNodes(body, nodes, ctypes.byref(n))
    if rc != 0:
        return f"census failed ({rc})"
    counts = [0] * len(NODE_TYPES)
    kernels = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            return "census failed (node type)"
        if 0 <= kind.value < len(NODE_TYPES):
            counts[kind.value] += 1
        if kind.value == 0 and len(kernels) < 16:
            value = (ctypes.c_int * 16)()       # CUlaunchAttributeValue
            kernels.append(tuple(
                value[0] if cu.cuGraphKernelNodeGetAttribute(
                    node, attr, value) == 0 else -1
                for attr in (CLUSTER_DIMENSION, MEM_SYNC_DOMAIN)))
    parts = [f"{NODE_TYPES[i]} {c}" for i, c in enumerate(counts) if c]
    if kernels:
        parts.append("kernels (cluster x, sync domain) " + " ".join(
            f"({x},{d})" for x, d in kernels))
    return ", ".join(parts)


class Agree:
    """Agreement of every rank through the store (no collective)."""

    def __init__(self, store, rank: int, world: int):
        self.store, self.rank, self.world, self.n = store, rank, world, 0

    def __call__(self, ok: bool) -> bool:
        self.n += 1
        self.store.set(f"agree{self.n}/{self.rank}", "1" if ok else "0")
        return all(self.store.get(f"agree{self.n}/{r}") == b"1"
                   for r in range(self.world))


def capture(make, lib, dev) -> tuple:
    """Capture a WHILE node of ITERATIONS runs of the case's body: (exec,
    graph, accumulators, iteration counter, census, error)."""
    i32 = torch.int32
    stream = graphloop._capture_stream(dev)
    begin_pool, end_pool = graphloop._pool_calls()
    accs, body = make()
    it = torch.zeros((), dtype=i32, device=dev)
    maxit = torch.full((), ITERATIONS, dtype=i32, device=dev)
    stop = torch.zeros((), dtype=i32, device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    torch.cuda.synchronize(dev)
    pool = torch.cuda.graph_pool_handle()
    cap = exe = None
    err, nodes = "", ""

    def cont(w):
        graphloop._check(lib.tfq_loop_continue(
            it.data_ptr(), maxit.data_ptr(), stop.data_ptr(), None, w, 1,
            stream.cuda_stream, None), "the continue kernel")

    try:
        with torch.cuda.stream(stream):
            begin_pool(dev.index, pool)
            try:
                cap = graphloop.GraphCapture(lib, stream)
                w = cap.handle()
                cont(w)
                with cap.node(w, graphloop.WHILE):
                    body(it)
                    it.add_(1)
                    cont(w)
                nodes = census(cap.bodies[0])
                exe = cap.end()
            finally:
                end_pool(dev.index, pool)
    except Exception as e:      # the capture's refusal is the finding
        err = f"{type(e).__name__}: {e}".splitlines()[0][:400]
        if cap is not None and cap.bodies and not nodes:
            nodes = census(cap.bodies[0])
        if cap is not None and exe is None:
            cap.abort()
    return exe, cap, accs, it, nodes, err


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("nccl_body_probe.py needs CUDA devices")
    faulthandler.dump_traceback_later(150, exit=True)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world < 2:
        raise SystemExit("nccl_body_probe.py needs two or more ranks")
    store = dist.distributed_c10d._get_default_store()
    agree = Agree(store, rank, world)
    lib = load_kernels()
    if rank == 0:
        print(f"nccl_body_probe: {world} ranks on "
              f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__},"
              f" CUDA {torch.version.cuda}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    # every communicator made and every eager reference run first
    cases = []
    for name, make in make_cases(rank, world, dev, store):
        accs, body = make()
        for k in range(ITERATIONS):
            body(torch.tensor(k, dtype=torch.int32, device=dev))
        torch.cuda.synchronize(dev)
        cases.append((name, make, [a.clone() for a in accs]))
    passed = 0
    for name, make, want in cases:
        exe, cap, accs, it, nodes, err = capture(make, lib, dev)
        if not agree(exe is not None):
            what = f"refused ({err or 'captured on this rank'})"
            ok = False
        else:
            done = torch.cuda.Event()
            graphloop._check(lib.tfq_loop_graph_launch(
                exe, torch.cuda.current_stream(dev).cuda_stream), "launch")
            done.record()
            deadline = time.monotonic() + LAUNCH_LIMIT_S
            while not done.query():
                if time.monotonic() > deadline:
                    print(f"rank {rank}: '{name}' launch did not finish in "
                          f"{LAUNCH_LIMIT_S:.0f} s", flush=True)
                    os._exit(3)
                time.sleep(0.01)
            same = int(it.item()) == ITERATIONS and all(
                torch.equal(g, w) for g, w in zip(accs, want))
            ok = agree(same)
            what = (f"{int(it.item())} iterations, results "
                    f"{'equal to' if same else 'NOT equal to'} the eager "
                    "run's")
        passed += ok
        if rank == 0 or not ok:
            print(f"nccl_body_probe: rank {rank}: {name}: "
                  f"{'PASS' if ok else 'FAIL'}: {what}; body: {nodes}",
                  flush=True)
    if rank == 0:
        print(f"nccl_body_probe: {passed} of {len(cases)} cases passed at "
              f"{world} ranks", flush=True)
    sys.stdout.flush()
    os._exit(0 if passed == len(cases) else 1)


if __name__ == "__main__":
    main()

"""One rank of the port's sharded tests, and the spawner that runs them.

    python tests/torch_sharded_worker.py CASE RANK WORLD STORE IN.npz OUT.npz

A rank process imports torch and the port, never JAX: it joins a gloo
process group on the CPU through a ``FileStore`` (no TCP port to collide
with other test workers), runs CASE on the inputs in IN.npz and, on rank 0,
writes what the test compares to OUT.npz.  ``run_ranks`` spawns the ranks
as fresh interpreters (never forked from a process that has started JAX),
gives them one time limit together, and kills all of them and fails when it
runs out or one rank fails, so that a hung collective never holds the
suite.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIME_LIMIT = 120.0


def pack_problem(a, x, b) -> dict:
    """Bsr operands -> npz-ready arrays (patterns, and data where set)."""
    out = {}
    for key, m in (("a", a), ("x", x), ("b", b)):
        out[f"{key}_shape"] = np.array([m.nrows, m.ncols])
        out[f"{key}_rowptr"] = np.asarray(m.rowptr)
        out[f"{key}_colind"] = np.asarray(m.colind)
        if m.data is not None:
            out[f"{key}_data"] = np.asarray(m.data)
    return out


def pack_problems(**problems) -> dict:
    """Several named problems (name -> (a, x, b)) in one npz-ready dict."""
    return {f"{name}.{k}": v for name, abx in problems.items()
            for k, v in pack_problem(*abx).items()}


def run_ranks(case: str, world: int, inputs: dict, tmp_path,
              timeout: float = TIME_LIMIT) -> dict:
    """Run CASE on ``world`` spawned ranks; rank 0's output as a dict."""
    tmp_path = str(tmp_path)
    inp = os.path.join(tmp_path, f"{case}_in.npz")
    out = os.path.join(tmp_path, f"{case}_out.npz")
    store = os.path.join(tmp_path, f"{case}_store")
    np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(tmp_path, f"{case}_rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         store, inp, out], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks did not finish in {timeout:.0f} s"
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    text = []
    for r, log in enumerate(logs):
        log.seek(0)
        text.append(f"--- rank {r}\n{log.read()[-3000:]}")
        log.close()
    if failed:
        raise AssertionError(f"{case} at {world} ranks: {failed}\n"
                             + "\n".join(text))
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------ rank side

def _problem(d: dict, name: str = ""):
    from tfqmrgpu_tpu_torch.bsr import Bsr

    pre = f"{name}." if name else ""
    return [Bsr(int(d[f"{pre}{k}_shape"][0]), int(d[f"{pre}{k}_shape"][1]),
                d[f"{pre}{k}_rowptr"], d[f"{pre}{k}_colind"],
                d.get(f"{pre}{k}_data"), k)
            for k in ("a", "x", "b")]


def _plan(d: dict, a, x, b):
    from tfqmrgpu_tpu_torch import create_plan

    plan = create_plan(a, x, b, device="cpu")
    plan.lm, plan.ln = int(d["lm"]), int(d["ln"])
    return plan


def _v3(d: dict):
    return (d["v3_re"], d["v3_im"]) if "v3_re" in d else None


def _info(info: dict) -> dict:
    return {k: np.asarray(v) for k, v in info.items()}


def case_blocklist(d: dict) -> dict:
    """The block-list sharded solve (K1's plain version per shard)."""
    from tfqmrgpu_tpu_torch.parallel import (make_mesh, partition_plan,
                                             sharded_solve)

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    pr, pc = (int(v) for v in d["grid"])
    mesh = make_mesh(pr, pc, device="cpu")
    trivial = bool(d["rhs_trivial"])
    b_re = np.zeros((plan.nnzb_b, plan.lm, plan.ln)) if trivial \
        else b.data.real
    b_im = np.zeros_like(b_re) if trivial else b.data.imag
    x_re, x_im, info = sharded_solve(
        plan, partition_plan(plan, pr, pc), mesh, a.data.real, a.data.imag,
        b_re, b_im, tolerance=float(d["tol"]),
        max_iterations=int(d["maxit"]), rhs_trivial=trivial, v3=_v3(d))
    return dict(x=x_re + 1j * x_im, all_gather=mesh.calls["all_gather"],
                all_reduce=mesh.calls["all_reduce"], **_info(info))


def case_world1(d: dict) -> dict:
    """At world size 1: the block-list sharded solve and the port's
    single-device solve with the same v3, the panel engine against the
    single-device 'dense' one, and a mesh of CUDA tensors over the gloo
    group."""
    import torch

    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch.errors import TfqmrgpuError
    from tfqmrgpu_tpu_torch.parallel import (Mesh, ShardedPanelSolver,
                                             make_mesh, partition_plan,
                                             sharded_solve)

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    mesh = make_mesh(1, 1, device="cpu")
    tol, maxit = float(d["tol"]), int(d["maxit"])
    x_re, x_im, info = sharded_solve(
        plan, partition_plan(plan, 1, 1), mesh, a.data.real, a.data.imag,
        b.data.real, b.data.imag, tolerance=tol, max_iterations=maxit,
        v3=_v3(d))
    s = tt.Solver(a, x, b, precision="z", engine="pairs", device="cpu",
                  v3=_v3(d))
    si = s.solve(tolerance=tol, max_iterations=maxit)
    xp, ip = ShardedPanelSolver(plan, mesh, precision="z", v3=_v3(d)).solve(
        a.data.real, a.data.imag, b.data.real, b.data.imag, tolerance=tol,
        max_iterations=maxit)
    sd = tt.Solver(a, x, b, precision="z", engine="dense", device="cpu",
                   v3=_v3(d))
    di = sd.solve(tolerance=tol, max_iterations=maxit)
    # a gloo group cannot carry the collectives of CUDA tensors
    world = torch.distributed.group.WORLD
    try:
        Mesh(1, 1, 0, 0, world, world, world, torch.device("cuda", 0))
        refused = ""
    except TfqmrgpuError as e:
        refused = str(e)
    return dict(x=x_re + 1j * x_im, iterations=info["iterations"],
                status=info["return_status"], x1=s.get_matrix("X"),
                iterations1=si.iterations_needed, status1=si.return_status,
                xp=xp, iterations_p=ip["iterations"],
                xd=sd.get_matrix("X"), iterations_d=di.iterations_needed,
                refused=refused)


def case_rowtile(d: dict) -> dict:
    from tfqmrgpu_tpu_torch.parallel import ShardedRowTileSolver, make_mesh

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    sp = ShardedRowTileSolver(plan, make_mesh(int(d["pr"]), 1, device="cpu"),
                              r_tile=int(d["r_tile"]))
    got, info = sp.solve(a.data.real, a.data.imag, b.data.real, b.data.imag,
                         tolerance=float(d["tol"]),
                         max_iterations=int(d["maxit"]))
    return dict(x=got, **_info(info))


def case_panel(d: dict) -> dict:
    from tfqmrgpu_tpu_torch.parallel import ShardedPanelSolver, make_mesh

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    pr, pc = (int(v) for v in d["grid"])
    sp = ShardedPanelSolver(plan, make_mesh(pr, pc, device="cpu"),
                            precision=str(d["precision"]))
    got, info = sp.solve(a.data.real, a.data.imag, b.data.real, b.data.imag,
                         tolerance=float(d["tol"]),
                         max_iterations=int(d["maxit"]))
    return dict(x=got, **_info(info))


def case_solve_sharded(d: dict) -> dict:
    """``solve_sharded`` once per entry of ``runs`` (engine, precision,
    tolerance, max_iterations); an error is returned, not raised, with the
    row-tile solvers built and K3 launches made in its call, and the
    grid's size."""
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch.errors import TfqmrgpuError
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply
    from tfqmrgpu_tpu_torch.parallel import ShardedRowTileSolver, solve_sharded

    a, x, b = _problem(d)
    built = []
    init = ShardedRowTileSolver.__init__

    def counting_init(self, *args, **kw):
        built.append(1)
        init(self, *args, **kw)

    ShardedRowTileSolver.__init__ = counting_init
    out = {}
    for i, (engine, precision, tol, maxit) in enumerate(d["runs"].tolist()):
        built.clear()
        launches = RowTileMultiply.launches
        try:
            got, info = solve_sharded(a, x, b, engine=engine,
                                      precision=precision,
                                      tolerance=float(tol),
                                      max_iterations=int(maxit),
                                      device="cpu")
            out[f"{i}_x"] = got
            out.update({f"{i}_{k}": v for k, v in _info(info).items()})
        except TfqmrgpuError as e:
            out[f"{i}_error"] = np.array(str(e))
        out[f"{i}_built"] = np.array(len(built))
        out[f"{i}_k3"] = np.array(RowTileMultiply.launches - launches)
    out["world"] = np.array(dist.get_world_size())
    return out


LAYOUT_FIELDS = ("tiles_local", "p", "q", "n_loc", "overlap", "halo",
                 "h_lo", "h_hi", "group_size")


def case_pairs(d: dict) -> dict:
    """The sharded packed-pairs engine over all ranks, once per row of
    ``runs``: (problem, overlap, halo, group_size, tolerance,
    max_iterations, v3: a key of ``d`` holding (re, im) or "").  At world
    size 1 each run also solves with ``Solver(engine='pairs')`` (the same
    v3) in this process, for the bits."""
    import torch.distributed as dist

    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch.parallel import ShardedPairsSolver, make_mesh

    world = dist.get_world_size()
    mesh = make_mesh(world, 1, device="cpu")
    out = {}
    for i, (name, overlap, halo, group, tol, maxit, v3) in enumerate(
            d["runs"].tolist()):
        a, x, b = _problem(d, name)
        plan = _plan(dict(lm=a.data.shape[1], ln=b.data.shape[2]), a, x, b)
        v3 = (d[f"{v3}_re"], d[f"{v3}_im"]) if v3 else None
        sp = ShardedPairsSolver(plan, mesh, overlap=overlap == "1",
                                halo=halo == "1", group_size=int(group))
        mesh.calls.clear()
        got, info = sp.solve(a.data.real, a.data.imag, b.data.real,
                             b.data.imag, tolerance=float(tol),
                             max_iterations=int(maxit), v3=v3)
        out[f"{i}_x"] = got
        out.update({f"{i}_{k}": v for k, v in _info(info).items()})
        out.update({f"{i}_{k}": np.asarray(getattr(sp.layout, k))
                    for k in LAYOUT_FIELDS})
        out.update({f"{i}_{k}": np.asarray(mesh.calls[k]) for k in
                    ("all_gather", "all_reduce", "neighbour_exchange")})
        if world == 1:
            s = tt.Solver(a, x, b, precision="c", engine="pairs",
                          device="cpu", v3=v3)
            si = s.solve(tolerance=float(tol), max_iterations=int(maxit))
            out[f"{i}_x1"] = s.get_matrix("X")
            out[f"{i}_iterations1"] = np.asarray(si.iterations_needed)
    return out


def case_precision(d: dict) -> dict:
    """The sharded engines in a bf16 split mode over all ranks:
    ``ShardedPairsSolver(precision=pairs_prec)`` and
    ``ShardedRowTileSolver(mm_prec=rowtile_prec, r_tile=r_tile)``."""
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsSolver,
                                             ShardedRowTileSolver, make_mesh)

    a, x, b = _problem(d)
    mesh = make_mesh(dist.get_world_size(), 1, device="cpu")
    out = {}
    for engine in ("pairs", "pallas"):
        plan = _plan(d, a, x, b)
        if engine == "pairs":
            sp = ShardedPairsSolver(plan, mesh,
                                    precision=str(d["pairs_prec"]))
        else:
            sp = ShardedRowTileSolver(plan, mesh, r_tile=int(d["r_tile"]),
                                      mm_prec=str(d["rowtile_prec"]))
        got, info = sp.solve(a.data.real, a.data.imag, b.data.real,
                             b.data.imag, tolerance=float(d["tol"]),
                             max_iterations=int(d["maxit"]))
        out[f"{engine}_x"] = got
        out.update({f"{engine}_{k}": v for k, v in _info(info).items()})
    return out


def case_dryrun(d: dict) -> dict:
    from tfqmrgpu_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(device="cpu")
    return {f"{tag}.{k}": np.asarray(v) for tag, r in res.items()
            for k, v in r.items()}


def case_scaling(d: dict) -> dict:
    from tfqmrgpu_tpu_torch.parallel.scaling import (run_point,
                                                     weak_scaling_report)

    kw = dict(lm=4, ln=4, ncols=2, tolerance=1e-6, max_iterations=200,
              repeats=1, device="cpu")
    p1 = run_point(1, 1, mb_per_shard=8, **kw)
    p2 = run_point(2, 1, mb_per_shard=8, **kw)
    p1_16 = run_point(1, 1, mb_per_shard=16, **kw)
    rep = weak_scaling_report(max_devices=2, mb_per_shard=8, **kw)
    out = {f"p1_{k}": v for k, v in vars(p1).items()}
    out.update({f"p2_{k}": v for k, v in vars(p2).items()})
    out.update({f"p1_16_{k}": v for k, v in vars(p1_16).items()})
    for k in ("pr", "iterations", "efficiency", "wall_s"):
        out[f"rep_{k}"] = np.array([r[k] for r in rep])
    return out


def case_nanmax(d: dict) -> dict:
    """The max over the mesh of each rank's value and the "all" of each
    rank's flag, as the sharded decisions take them (``Mesh.reduce_max`` of
    ``core.decision_partials``), one scenario a row of ``values`` /
    ``flags`` (column r: rank r's), and every rank's answers gathered, so
    that rank 0 can show that they agree."""
    import torch

    from tfqmrgpu_tpu_torch import core
    from tfqmrgpu_tpu_torch.parallel import make_mesh

    world = int(d["world"])
    mesh = make_mesh(world, 1, device="cpu")
    r = mesh.row

    def reduced(value: float, flag: bool) -> torch.Tensor:
        return mesh.reduce_max(core.decision_partials(
            torch.tensor(value, dtype=torch.float64), torch.tensor(flag),
            mesh.ranks == 1))

    got = torch.stack([reduced(float(v[r]), False)[0] for v in d["values"]])
    anded = torch.stack([reduced(0.0, bool(f[r]))[1] < 0
                         for f in d["flags"]]).to(torch.int32)
    return dict(max=mesh.gather(got).reshape(world, -1).numpy(),
                all=mesh.gather(anded).reshape(world, -1).numpy())


def case_agree(d: dict) -> dict:
    """The agreements a sharded loop graph's capture makes (``Mesh.agree``)
    on a mesh of rank 0 alone, then on a mesh of both ranks: rank 0 agrees
    3 times alone; on the mesh of two a capture that failed on rank 1
    fails on both, and one that held on both holds.  Every rank's answers,
    gathered."""
    import torch

    from tfqmrgpu_tpu_torch.parallel import make_mesh

    alone = make_mesh(1, 1, device="cpu")
    held_alone = [alone.agree(True) for _ in range(3)] if alone.member \
        else [True] * 3
    both = make_mesh(2, 1, device="cpu")
    failed = both.agree(both.row == 0)
    held = both.agree(True)
    got = torch.tensor(held_alone + [failed, held], dtype=torch.int32)
    return dict(agreed=both.gather(got).reshape(2, -1).numpy())


def case_shutdown(d: dict) -> dict:
    """``multihost.shutdown`` closes every live loop graph of a sharded
    solve (``graphloop._sharded``; stand-ins here, as a loop graph needs a
    card) and then destroys the process group."""
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch import graphloop
    from tfqmrgpu_tpu_torch.parallel import multihost

    class Graph:
        closed = 0

        def close(self):
            self.closed += 1

    graphs = [Graph() for _ in range(3)]
    for g in graphs:
        graphloop._sharded.add(g)
    multihost.shutdown()
    return dict(closed=[g.closed for g in graphs],
                left=len(graphloop._sharded),
                initialized=dist.is_initialized())


class _DryCapture:
    """A capture that captures nothing: ``graphloop.record`` under it runs
    the loop's outer part, one iteration and one probe eagerly."""

    def handle(self):
        return None

    def node(self, handle, kind: int):
        import contextlib

        return contextlib.nullcontext()


class _PlainControl:
    """``graphloop.LoopControl`` on CPU tensors: ``core``'s plain versions,
    in place."""

    @staticmethod
    def decide(c, inv_bn2, maxit, max_bound2, probe, handle=None):
        from tfqmrgpu_tpu_torch import core

        stop, bound2, go = core.decide(c, inv_bn2, maxit)
        c.stop_code.copy_(stop)
        max_bound2.copy_(bound2)
        probe.copy_(go)

    @staticmethod
    def settle(c, res2, max_bound2, tol2):
        from tfqmrgpu_tpu_torch import core

        _PlainControl._into(c, core.settle(c, res2, max_bound2, tol2))

    @staticmethod
    def decide_local(c, inv_bn2, part, keep_nan):
        from tfqmrgpu_tpu_torch import core

        part.copy_(core.decide_local(c, inv_bn2, keep_nan))

    @staticmethod
    def decide_finish(c, part, maxit, max_bound2, probe, handle=None):
        from tfqmrgpu_tpu_torch import core

        stop, bound2, go = core.decide_finish(c, part, maxit)
        c.stop_code.copy_(stop)
        max_bound2.copy_(bound2)
        probe.copy_(go)

    @staticmethod
    def settle_local(c, res2, tol2, part, keep_nan):
        from tfqmrgpu_tpu_torch import core

        status, p = core.settle_local(c, res2, tol2, keep_nan)
        c.status.copy_(status)
        part.copy_(p)

    @staticmethod
    def settle_finish(c, part, max_bound2, tol2):
        from tfqmrgpu_tpu_torch import core

        _PlainControl._into(c, core.settle_finish(c, c.status, part,
                                                  max_bound2, tol2))

    @staticmethod
    def cont(c, maxit, go=None, handle=None):
        pass

    @staticmethod
    def _into(c, s):
        for name in ("status", "residual2", "target_bound2", "stop_code",
                     "iters_needed", "n_probes"):
            getattr(c, name).copy_(getattr(s, name))


def case_sharded_record(d: dict) -> dict:
    """Every loop of a sharded solve (``engine``: 'blocklist', 'rowtile'
    or 'pairs') also recorded as the loop graph holds it
    (``graphloop.record``) under a dry capture and the plain control, at
    maxit 1, and run by ``core.plain_loop`` at maxit 1: X, the final
    scalars and the collectives of each kind must agree to the bit on every
    rank.  Then the solve itself runs on, on the plain driver."""
    import torch

    from tfqmrgpu_tpu_torch import core, graphloop
    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsSolver,
                                             ShardedRowTileSolver, make_mesh,
                                             partition_plan, sharded_solve)

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    pr, pc = (int(v) for v in d["grid"])
    mesh = make_mesh(pr, pc, device="cpu")
    kinds = ("all_gather", "all_reduce", "neighbour_exchange")
    loop, seen = core.tfqmr_loop, []

    def both(prim, v2, v3, v5_init, tau0, inv_bn2, tolerance,
             max_iterations, dt, **kw):
        tol2 = float(tolerance) ** 2
        mesh.calls.clear()
        want = core.plain_loop(prim, v2, v3, v5_init, tau0, inv_bn2, tol2, 1,
                               dt)
        calls_plain = [mesh.calls[k] for k in kinds]
        ins = graphloop.LoopInputs(
            v2=v2, v3=v3, v5_init=v5_init, tau0=tau0, inv_bn2=inv_bn2,
            tol2=torch.tensor(tol2, dtype=torch.float64),
            maxit=torch.tensor(1, dtype=torch.int32))
        mesh.calls.clear()
        control, graphloop.LoopControl = graphloop.LoopControl, _PlainControl
        try:
            c, state = graphloop.record(prim, ins, dt, _DryCapture())
        finally:
            graphloop.LoopControl = control
        calls_record = [mesh.calls[k] for k in kinds]
        stop, iters_needed, it, n_probes, residual2 = state.tolist()
        got = core.solve_result(c, stop, iters_needed, n_probes, residual2)
        same = (it == 1 and calls_record == calls_plain
                and (got.return_status, got.iterations, got.n_probes)
                == (want.return_status, want.iterations, want.n_probes)
                and np.float64(got.residuum).tobytes()
                == np.float64(want.residuum).tobytes()
                and all(torch.equal(g, w) for g, w in
                        zip(graphloop._leaves(got.x),
                            graphloop._leaves(want.x)))
                and torch.equal(got.rhs_status, want.rhs_status))
        if not same:
            def scalars(r):
                return (r.return_status, r.iterations, r.n_probes,
                        r.residuum)
            raise AssertionError(
                f"rank {mesh.row}: the recorded loop differs from the plain "
                f"driver's: calls {calls_record} / {calls_plain}, "
                f"(status, iterations, probes, residuum) {scalars(got)} / "
                f"{scalars(want)}")
        seen.append(calls_plain)
        return loop(prim, v2, v3, v5_init, tau0, inv_bn2, tolerance,
                    max_iterations, dt, **kw)

    core.tfqmr_loop = both
    try:
        tol, maxit = float(d["tol"]), int(d["maxit"])
        engine = str(d["engine"])
        planes = (a.data.real, a.data.imag, b.data.real, b.data.imag)
        if engine == "blocklist":
            x_re, x_im, info = sharded_solve(
                plan, partition_plan(plan, pr, pc), mesh, *planes,
                tolerance=tol, max_iterations=maxit, v3=_v3(d))
            xs = x_re + 1j * x_im
        else:
            cls = ShardedRowTileSolver if engine == "rowtile" \
                else ShardedPairsSolver
            xs, info = cls(plan, mesh).solve(*planes, tolerance=tol,
                                             max_iterations=maxit)
    finally:
        core.tfqmr_loop = loop
    return dict(x=xs, loops=len(seen), first_calls=np.asarray(seen[0]),
                **_info(info))


def case_release(d: dict) -> dict:
    """Whether a sharded solver whose loop graphs hold its loop's
    primitives (as ``graphloop.LoopGraph`` does) is freed when its last
    reference goes, with the collector off: its graphs go with it, as
    NCCL needs before a communicator is destroyed.  For the row tiles and
    the packed pairs."""
    import gc
    import weakref

    from tfqmrgpu_tpu_torch import core
    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsSolver,
                                             ShardedRowTileSolver, make_mesh)

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    mesh = make_mesh(1, 1, device="cpu")
    loop, out = core.tfqmr_loop, {}
    for name, cls in (("rowtile", ShardedRowTileSolver),
                      ("pairs", ShardedPairsSolver)):
        sp = cls(plan, mesh)
        prims = []

        def keep(prim, *args, **kw):
            prims.append(prim)
            return loop(prim, *args, **kw)

        core.tfqmr_loop = keep
        try:
            sp.solve(a.data.real, a.data.imag, b.data.real, b.data.imag,
                     tolerance=1e-4, max_iterations=50)
        finally:
            core.tfqmr_loop = loop
        sp.loop_graphs._graphs["held"] = prims[0]
        ref = weakref.ref(sp)
        del prims
        gc.disable()
        try:
            del sp
            out[name] = int(ref() is None)
        finally:
            gc.enable()
    return out


def case_rowtile_v3(d: dict) -> dict:
    """The sharded row tiles with a given shadow vector (JAX's)."""
    from tfqmrgpu_tpu_torch.parallel import ShardedRowTileSolver, make_mesh
    from tfqmrgpu_tpu_torch.parallel.multihost import put_global

    a, x, b = _problem(d)
    plan = _plan(d, a, x, b)
    mesh = make_mesh(int(d["pr"]), 1, device="cpu")
    sp = ShardedRowTileSolver(plan, mesh, r_tile=int(d["r_tile"]))
    sp.v3 = tuple(put_global(sp._shard_panel(sp.lay.pack_x(v)), mesh,
                             ("rows",)) for v in _v3(d))
    got, info = sp.solve(a.data.real, a.data.imag, b.data.real, b.data.imag,
                         tolerance=float(d["tol"]),
                         max_iterations=int(d["maxit"]))
    return dict(x=got, **_info(info))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(argv) -> int:
    case, rank, world, store_path, inp, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(store=dist.FileStore(store_path, world),
                         world_size=world, rank=rank, device="cpu")
    with np.load(inp, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    result = CASES[case](data)
    if rank == 0:
        np.savez(out, **result)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    raise SystemExit(main(sys.argv[1:]))

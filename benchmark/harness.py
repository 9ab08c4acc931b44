"""One run of one cell: set-up, the measured window, the traced cycle, and
the judge.

Set-up makes the problem and the pool, picks the first point from the
seed, builds the system under test with it, and runs two warm solves (the first
loads the kernels and captures the loop graph, the second refills it with
another A), so that nothing compiles or captures inside the window.  The
window is the contour mix as a closed loop with one caller: set A, solve,
read X, for whole cycles of the pool, until ``seconds`` have passed; with
``trace`` the first cycle runs under the profiler.  The judge then compares a sample of the window's answers, one a point drawn
from the seed, with the reference, after the program's state is freed.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import counts, pool, problems, tracing
from .cells import Cell
from .problems import sub_seed
from .reference import judge

WARM_SOLVES = 2


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Sampler:
    """One kept answer a point, by reservoir sampling from the seed, so
    that every solve of a point is as likely to be judged."""

    def __init__(self, seed: int, points: int):
        self.rng = np.random.default_rng(sub_seed(seed, "sample"))
        self.seen = [0] * points
        self.kept: dict = {}

    def offer(self, k: int, x: np.ndarray, iterations: int):
        self.seen[k] += 1
        if self.rng.random() * self.seen[k] < 1.0:
            self.kept[k] = (x, iterations)


def metric_reader(name: str) -> Callable:
    return importlib.import_module(f"{__package__}.metrics.{name}").read


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        make_solver: Optional[Callable] = None) -> dict:
    """The result of one run, as ``run.py`` prints it (``checks`` last).
    ``make_solver(problem, a0, config, device)`` builds the system under
    test, by default the port's Solver; ``t0`` is the process's start on
    the host clock."""
    from .program import PortSolver, k1_launches

    device = torch.device(device)
    cfg, points = cell.config, cell.points
    tol, maxit = float(cfg["tolerance"]), int(cfg["max_iterations"])
    on_card = device.type == "cuda"
    nk = int(points["count"])
    phases = {"imports": time.perf_counter() - t0}
    problem = problems.build(cfg, seed, device)
    work = pool.make_pool(problem, pool.shifts(points))
    start = pool.first_point(seed, nk)
    phases["problem"] = time.perf_counter() - t0
    if trace and on_card:
        # a graph captured before the process's first profiler session
        # shows its conditional bodies' kernels to a later one only once
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=device)
            _sync(device)
    solver = (make_solver or PortSolver)(problem, work[start], cfg, device)
    phases["solver"] = time.perf_counter() - t0
    for j in range(WARM_SOLVES):
        solver.set_a(work[(start + j) % nk])
        solver.solve(tol, maxit)
        solver.get_x()
        _sync(device)
        phases[f"warm{j}"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t0

    sampler = _Sampler(seed, nk)
    answers, traced, steps = [], [], []
    prof = k1_before = k1_after = None
    k, n, cycles = start, 0, 0
    w0 = time.perf_counter()
    while True:
        tracing_now = trace and cycles == 0
        if tracing_now and prof is None:
            if on_card and solver.engine == "pairs":
                k1_before = k1_launches()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if on_card else []))
            prof.start()
        if tracing_now:
            traced.append(_traced_solve(solver, work[k], tol, maxit, device))
            ans, x = traced[-1].pop("answer"), traced[-1].pop("x")
        else:
            ts, c0 = time.perf_counter(), time.process_time()
            solver.set_a(work[k])
            t1, c1 = time.perf_counter(), time.process_time()
            ans = solver.solve(tol, maxit)
            t2, c2 = time.perf_counter(), time.process_time()
            x = solver.get_x()
            steps.append((k, ans.iterations, ans.probes, t1 - ts, t2 - t1,
                          time.perf_counter() - t2, c1 - c0,
                          time.process_time() - c2))
        answers.append(ans)
        sampler.offer(k, x, ans.iterations)
        del x
        n += 1
        k = (k + 1) % nk
        if n % nk == 0:
            cycles += 1
            if prof is not None and cycles == 1:    # one traced cycle
                _sync(device)
                prof.stop()
                if k1_before is not None:
                    k1_after = k1_launches()
            if time.perf_counter() - w0 >= seconds:
                break
    window_s = time.perf_counter() - w0

    result = {"correct": False, "attempted": n,
              "failed": sum(a.status != 0 for a in answers), "metrics": {}}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if on_card else 0)}
    engine = solver.engine
    if trace:
        t = tracing.Trace(solves=traced, spans=[], events=[])
        if prof is not None:
            t.spans, t.events = tracing.from_profiler(prof)
        if k1_before is not None:
            t.k1_launches = k1_after - k1_before
            try:
                t.k1_bound_s = counts.bound_seconds(
                    counts.multiply(problem, cfg["precision"]),
                    dev_info["kind"])
            except KeyError:
                t.k1_bound_s = None
        for m in cell.per_layer:
            value = metric_reader(m["name"])(t)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if on_card:
            dev_info["busy_s"] = t.busy_s()
            dev_info["window_s"] = t.window_s()
            result["breakdown"] = tracing.breakdown(t)
    else:
        e2e = {"solve_call_ms": 1e3 * sum(s[4] for s in steps) / n,
               "setup_s": setup_s}
        if on_card:
            e2e["peak_mem_gib"] = dev_info["memory_peak_bytes"] / 2 ** 30
        for m in cell.end_to_end:
            if m["name"] in e2e:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    result["device"] = dev_info
    result["engine"] = engine
    # the window's wall over its solves: set A, solve and read X together
    result["point_ms"] = 1e3 * window_s / n
    # seconds from the process's start to the end of each phase of set-up
    result["setup"] = {k: round(v, 3) for k, v in phases.items()}
    # each untraced solve of the window: point, iterations, probes; the
    # wall ms in set A, in solve and in reading X; the process's CPU ms in
    # set A and in reading X
    result["solves"] = [[s[0], s[1], s[2],
                         *(round(1e3 * v, 2) for v in s[3:])] for s in steps]

    # the judge, once the program's state is freed
    del solver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = [judge.read(problem, work[j], x, it, tol, maxit, device)
                for j, (x, it) in sorted(sampler.kept.items())]
    numbers = judge.combine(readings)
    correct, checks = judge.verdict(numbers, cfg.get("limits", {}),
                                    result["failed"], len(readings))
    result["correct"] = correct
    result["readings"] = [
        {"point": j, "iterations": sampler.kept[j][1],
         **{kk: r[kk] for kk in ("ref_iterations", "resid", "xdev",
                                 "iter_gap")}}
        for j, r in zip(sorted(sampler.kept), readings)]
    result["checks"] = checks
    return result


def _traced_solve(solver, a, tol, maxit, device) -> dict:
    """One solve with the benchmark's spans and CUDA events around it."""
    rf = torch.profiler.record_function
    on_card = device.type == "cuda"
    t = time.perf_counter()
    with rf("bench.set_a"):
        solver.set_a(a)
        _sync(device)
    set_a_s = time.perf_counter() - t
    ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
          if on_card else None)
    with rf("bench.solve"):
        if ev:
            ev[0].record()
        ans = solver.solve(tol, maxit)
        if ev:
            ev[1].record()
        _sync(device)
    t = time.perf_counter()
    with rf("bench.get_x"):
        x = solver.get_x()
    get_x_s = time.perf_counter() - t
    return {"answer": ans, "x": x, "set_a_s": set_a_s, "get_x_s": get_x_s,
            "iterations": ans.iterations, "probes": ans.probes,
            "loop_ms": ev[0].elapsed_time(ev[1]) if ev else None}

"""Where the time of a solve of the PyTorch port goes, on one CUDA card.

    python3 tools/profile_torch_port.py

Runs four solves of ``chip_smoke.py`` through ``tfqmrgpu_tpu_torch``:
FD rtb=12.75 'z' to 1e-9 (pairs engine, K1), and the golden-class plan for
20 fixed iterations in 'z' (pairs engine, K1) and 10 each in 'c' through
the row-tile engine (K3) and the packed pairs engine (K2, G = 8).
Each is solved once to warm up, once on the host clock, and once under
``torch.profiler``.  Device time is the sum of the durations of the events
the profiler places on the card (kernels, copies, fills); the aten operators
that launched them are not counted again.  The busy share is that device
time over the unprofiled wall.  Prints one summary line per solve and its
eight most expensive device kernels; the hand-written kernel's share is
printed beside the rest (the vector passes, copies and fills).  Each solve
is one launch of its loop's CUDA graph: the totals are the graph's, but
the profiler may give the graph's kernels the names of others, so the
per-kernel lines and the hand-written kernel's share are read with that
in mind (PERF.md §6).
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (dominant_fill, golden_c_problem,  # noqa: E402
                        golden_class_patterns)


def device_events(prof):
    """(name, microseconds) of every event the profiler put on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == cuda]


def profile_solve(label: str, solver, tolerance: float, max_iterations: int,
                  counter, kernel_name: str):
    """Profile one solve; ``counter`` is the wrapper class whose
    ``launches`` count the hand-written kernel ``kernel_name``.  The first
    solve captures the loop's CUDA graph inside a profiler session: a graph
    instantiated while the profiler's CUPTI is off shows the kernels of its
    conditional bodies to a later profile once, not at every iteration."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        solver.solve(tolerance=tolerance, max_iterations=max_iterations)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = solver.solve(tolerance=tolerance, max_iterations=max_iterations)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    iters = info.iterations_needed

    launches0 = counter.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solver.solve(tolerance=tolerance, max_iterations=max_iterations)
        torch.cuda.synchronize()
    k_launches = counter.launches - launches0
    events = device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    total = collections.Counter()
    count = collections.Counter()
    for name, us in events:
        total[name] += us
        count[name] += 1
    dev_ms = sum(total.values()) / 1e3
    k_ms = sum(us for name, us in total.items() if kernel_name in name) / 1e3
    print(f"[{label}] {iters} iterations, {info.n_probes} probes; wall "
          f"{wall_ms:.3f} ms ({wall_ms / iters:.3f} ms per iteration); device "
          f"{dev_ms:.3f} ms ({dev_ms / iters:.3f} ms per iteration, "
          f"{100 * dev_ms / wall_ms:.1f}% of the wall); "
          f"{len(events)} device events ({len(events) / iters:.0f} per "
          f"iteration); {kernel_name} {k_ms:.3f} ms over {k_launches} "
          f"launches ({100 * k_ms / dev_ms:.1f}% of device time), the rest "
          f"{dev_ms - k_ms:.3f} ms", flush=True)
    for name, us in total.most_common(8):
        print(f"   {us / 1e3:9.3f} ms  n={count[name]:6d}  {name[:90]}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port.py needs a CUDA device")
    from tfqmrgpu_tpu_torch import Solver
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem
    from tfqmrgpu_tpu_torch.ops.pairpanel import (PairPanelMultiply,
                                                  PairPlanMultiply)
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")

    fd = generate_fd_problem(rtb=12.75)
    s = Solver(fd.a_with_data(), fd.x, fd.b_with_data(), precision="z",
               device=dev)
    profile_solve("FD rtb=12.75", s, 1e-9, 2000, PairPlanMultiply,
                  "pairpanel_spmm_mma_kernel")

    rng = np.random.default_rng(281)
    a, x, b = golden_class_patterns()
    a = a.with_data(dominant_fill(rng, a.nnzb, 11, 32))
    b = b.with_data(rng.standard_normal((b.nnzb, 32, 32, 2)) @ [1, 1j])
    s = Solver(a, x, b, precision="z", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    profile_solve("golden-class 'z', 20 fixed iterations", s, 0.0, 20,
                  PairPlanMultiply, "pairpanel_spmm_mma_kernel")
    print(f"[golden-class 'z'] peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB", flush=True)

    a, x, b = golden_c_problem()
    s = Solver(a, x, b, precision="c", device=dev)
    if s.engine != "pallas":
        raise RuntimeError(f"auto picked {s.engine} for the golden 'c' plan")
    torch.cuda.reset_peak_memory_stats(dev)
    # float32 stops every column of this system by itself after 12
    # iterations (breakdown flags), so 10 fixed iterations are profiled
    profile_solve("golden-class 'c' (row-tile), 10 fixed iterations", s, 0.0,
                  10, RowTileMultiply, "rowtile_spmm_kernel")
    print(f"[golden-class 'c'] peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB", flush=True)

    s = Solver(a, x, b, precision="c", engine="pairs", device=dev)
    if s._gp is None or s._gp.group_size != 8:
        raise RuntimeError("the golden 'c' pairs plan is not grouped by 8")
    torch.cuda.reset_peak_memory_stats(dev)
    profile_solve("golden-class 'c' (packed pairs, G 8), 10 fixed iterations",
                  s, 0.0, 10, PairPanelMultiply, "pairpanel_tiles_kernel")
    print(f"[golden-class 'c' pairs] peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB", flush=True)


if __name__ == "__main__":
    main()

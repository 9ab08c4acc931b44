"""What ``torch.profiler`` sees of the loop's CUDA graph, on one card.

    python3 tools/loop_graph_profile.py

A solve on the card is one launch of its loop graph (``graphloop.py``): a
WHILE node runs the iteration's kernels once an iteration, an IF node the
probe's.  This tool solves the golden-class 'c' system on the row tiles
(K3, 4 iterations and 2 probes: 10 K3 launches) with three Solvers, whose
graphs are captured (a) before any profiler session of the process, (b)
inside one and (c) after one, and profiles each Solver's next solves.  For
each it prints the events the profile holds in all, the events it names as
K3's kernel, and the solve's K3 launches by ``RowTileMultiply.launches``;
then the same for the plain driver on (a)'s Solver.  It reads the card and
needs one.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import golden_c_problem, plain_driver  # noqa: E402


def profiled(solver, reps: int = 3) -> list:
    """(events, events named K3's, K3 launches) of ``reps`` profiled
    solves."""
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for _ in range(reps):
        before = RowTileMultiply.launches
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            solver.solve(tolerance=1e-5, max_iterations=500)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == cuda]
        out.append((len(ev), sum("rowtile_spmm_kernel" in e.name for e in ev),
                    RowTileMultiply.launches - before))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("loop_graph_profile.py needs a CUDA device")
    from tfqmrgpu_tpu_torch import Solver

    def solver():
        return Solver(*golden_c_problem(), precision="c", engine="pallas",
                      device="cuda")

    a = solver()
    a.solve(tolerance=1e-5, max_iterations=500)
    b = solver()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        b.solve(tolerance=1e-5, max_iterations=500)
        torch.cuda.synchronize()
    c = solver()
    c.solve(tolerance=1e-5, max_iterations=500)
    print(torch.cuda.get_device_name(0))
    for label, s in (("(a) captured before any profiler session", a),
                     ("(b) captured inside a session", b),
                     ("(c) captured after a session", c)):
        print(f"{label}: (events, named K3, K3 launches) {profiled(s)}")
    with plain_driver():
        print(f"plain driver on (a)'s Solver: {profiled(a)}")


if __name__ == "__main__":
    main()

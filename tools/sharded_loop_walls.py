"""The sharded loop graph against the plain driver, at full width, on N
cards.

    torchrun --standalone --nproc_per_node=N tools/sharded_loop_walls.py
    torchrun --standalone --nproc_per_node=N tools/sharded_loop_walls.py \\
        --device cpu --small               (gloo: a rehearsal, counts only)

On an N x 1 mesh it solves FD rtb=12.75 'z' through ``sharded_solve``
(K1 per shard) and the golden-class 'c' system through
``ShardedPairsSolver`` (K2 per shard, the halo collective beside the
local tiles), each through its loop graph (one CUDA graph a rank, the
collectives in the WHILE body) and again through the plain driver
(``core.plain_loop``) on the same mesh.  Rank 0 prints for each: the
layout, iterations and probes of both drivers, whether their X agree to
the bit (else the largest deviation), the collectives of each kind an
iteration (the card's counters), the capture's host time, and each
loop's wall alone (CUDA events around the graph's launch and state read,
or around the plain driver's loop; ``chip_smoke.timed_loops``) in ms an
iteration, the median of ``--reps`` solves.  It prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import golden_c_problem, plain_driver, timed_loops  # noqa

KINDS = ("all_gather", "all_reduce", "neighbour_exchange")


def run(mesh, solve, reps: int, cuda: bool) -> dict:
    """``solve()`` -> (X, info) through the graph and the plain driver."""
    from tfqmrgpu_tpu_torch.graphloop import LoopGraph

    out = {}
    for plain in (False, True):
        if plain and not cuda:
            break
        walls = []
        cap0 = LoopGraph.capture_seconds
        for _ in range(reps):
            mesh.calls.clear()
            with (plain_driver() if plain else _null()), \
                    (timed_loops() if cuda else _null()) as t:
                x, info = solve()
            if cuda:
                walls.append(t[0][0] / max(t[0][3], 1))
        out["plain" if plain else "graph"] = dict(
            x=np.asarray(x), iterations=int(info["iterations"]),
            probes=int(info["n_probes"]),
            calls={k: int(mesh.calls[k]) for k in KINDS},
            ms_per_it=statistics.median(walls) if walls else None,
            capture_ms=1e3 * (LoopGraph.capture_seconds - cap0))
    return out


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def report(tag: str, r: dict, extra: str):
    g, p = r["graph"], r.get("plain")
    its = g["iterations"]
    calls = ", ".join(f"{g['calls'][k] / its:.2f} {k}" for k in KINDS)
    text = (f"sharded_loop_walls: {tag} ({extra}): graph {its} iterations, "
            f"{g['probes']} probes, {calls} an iteration")
    if p is not None:
        dx = float(np.max(np.abs(g["x"] - p["x"])))
        text += (f"; plain driver {p['iterations']} iterations, "
                 f"{p['probes']} probes, collectives "
                 f"{'equal' if p['calls'] == g['calls'] else p['calls']}, X "
                 + ("equal to the bit" if dx == 0 else f"within {dx:.3e}")
                 + f"; the loop alone: graph {g['ms_per_it']:.4f} ms an "
                 f"iteration, plain driver {p['ms_per_it']:.4f}; capture "
                 f"{g['capture_ms']:.1f} ms (host, all reps)")
    print(text, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where each rank runs (default: its card)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="FD rtb=6.75 and a 24-row golden pattern, for a "
                         "rehearsal on the CPU")
    args = ap.parse_args(argv)
    from tfqmrgpu_tpu_torch import create_plan
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem
    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsSolver, make_mesh,
                                             multihost, partition_plan,
                                             sharded_solve)

    dev = multihost.initialize(device=args.device)
    cuda = dev.type == "cuda"
    n, rank = dist.get_world_size(), dist.get_rank()
    if rank == 0 and cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"sharded_loop_walls: {n} ranks; "
              f"{card.stdout.strip().splitlines()[0]}", flush=True)
    mesh = make_mesh(n, 1, device=dev)

    rtb = 6.75 if args.small else 12.75
    fd = generate_fd_problem(rtb=rtb)
    a, b = fd.a_with_data(), fd.b_with_data()
    plan = create_plan(a, fd.x, b, device=dev)
    plan.lm, plan.ln = a.slow_block_dim, b.fast_block_dim
    part = partition_plan(plan, n, 1)

    def fd_solve():
        xr, xi, info = sharded_solve(
            plan, part, mesh, a.data.real, a.data.imag, b.data.real,
            b.data.imag, tolerance=1e-9, max_iterations=2000)
        return xr + 1j * xi, info

    r = run(mesh, fd_solve, args.reps, cuda)
    if rank == 0:
        report(f"FD rtb={rtb} 'z' sharded_solve {n} x 1", r,
               f"K1 per shard, {part.nmax} block slots a shard")

    ga, gx, gb = golden_c_problem(**(dict(mb=24, ncols=4) if args.small
                                     else {}))
    gplan = create_plan(ga, gx, gb, device=dev)
    gplan.lm, gplan.ln = 32, 32
    sp = ShardedPairsSolver(gplan, mesh)
    lay = sp.layout
    r = run(mesh, lambda: sp.solve(ga.data.real, ga.data.imag, gb.data.real,
                                   gb.data.imag, tolerance=1e-5,
                                   max_iterations=500), args.reps, cuda)
    if rank == 0:
        report(f"golden 'c' ShardedPairsSolver {n} x 1", r,
               f"K2 per shard, G {lay.group_size}, {lay.tiles_local} tiles a "
               f"shard, {lay.n_loc} local, halo "
               f"{'edge exchange' if lay.halo else 'all_gather'} "
               f"(h_lo {lay.h_lo}, h_hi {lay.h_hi}), overlap {lay.overlap}")
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The two readings that a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds S1 S2 ...
        [--control-seeds C1 C2 ...] [--out FILE]

For each seed of ``--seeds`` it runs the cell through the port for one
cycle of its contour (``harness.run`` with a window of 0 seconds: every
point once) and prints the judge's numbers: their largest over the seeds
is the lower reading.  For each seed of ``--control-seeds`` it runs the
control, the reference in complex64 in the program's place, on the same
cell, and prints its numbers: their smallest is the upper reading.  All
in one process; a line of JSON a run, also appended to ``--out``.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, harness
    from benchmark.reference.solver import ReferenceSolver

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload, ROOT)

    def control(*a):
        return ReferenceSolver(*a, dtype=torch.complex64)

    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, control) for s in args.control_seeds]
    for who, seed, make in runs:
        t = time.perf_counter()
        r = harness.run(cell, seed, 0.0, False, "cuda:0", t,
                        make_solver=make)
        line = {"workload": args.workload, "who": who, "seed": seed,
                "seconds": time.perf_counter() - t,
                "engine": r["engine"], "failed": r["failed"],
                "correct": r["correct"],
                **{k: c["value"] for k, c in r["checks"].items()},
                "points": r["readings"]}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

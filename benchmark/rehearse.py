"""Rehearse one cell on the CPU, for a builder without a card.

    python3 benchmark/rehearse.py --workload <cell> [--seed N] [--seconds S]
        [--trace 0|1] [--threads T]

It runs ``harness.run`` on the CPU: the port's plain versions in place of
its kernels and the plain driver in place of the loop graph.  The parts
that need the card are skipped: device memory, CUDA events, the device
trace and K1's counter, so the metrics that read them are left out.  The
window holds at least one whole cycle of the contour, and the judge runs
as on the card.  It prints the result as ``run.py`` does, under the key
``rehearsal``: no number of it is a device measurement.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, harness

    torch.set_num_threads(args.threads)
    cell = cells.load(args.workload, ROOT)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cpu", T0)
    print(json.dumps({"rehearsal": "cpu; skipped: device memory, CUDA "
                      "events, the device trace, K1's counter",
                      **result}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

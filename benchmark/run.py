"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads`` (see
``benchmark/README.md``).  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a profiled cycle, with the device's busy and window seconds and the
breakdown.  The last line of standard output is the result, one JSON
object; the numbers that decided ``correct`` are the last lines of
standard error and the last key of the result.  Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
in this process, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tfqmrgpu_tpu")


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, compared by
    their whole top-level name (``tfqmrgpu_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _finite(v):
    """The result with every float that is not finite written as a string,
    so that the line stays JSON."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, harness

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T0)
    found = loaded_forbidden()
    if found:
        print(f"JAX modules loaded in the benchmark's process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

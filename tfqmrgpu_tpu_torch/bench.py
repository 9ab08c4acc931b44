"""Benchmark/test CLI, parity with the reference's bench_tfqmrgpu program
(bench_tfqmrgpu.cu:561-590) in its ``tfQMR`` mode:

    python -m tfqmrgpu_tpu_torch.bench tfQMR <file.xml|legacy> [z|c|m] [nrep] [maxiter]

It runs the full solve on a problem file (XML or legacy dump), compares the
solution with the embedded reference solution (maxdev/avgdev/maxrel; the
performance line only when maxdev is under the gate, bench_tfqmrgpu.cu:
178-206) and reports iterations, residuum and TFlop/s.  'z' and 'c' run a
``Solver``; 'm' runs ``solve_mixed`` (complex64 iterations refined against
a float64 residual) and is held to the 'z' gate, since it returns
float64-quality X.  The solve runs on the CUDA card unless the environment
sets ``TFQ_DEVICE`` (for example ``TFQ_DEVICE=cpu``); ``TFQ_ENGINE`` picks
the engine ('auto' by default).  Each clock read follows a
``torch.cuda.synchronize()`` on the card.

The ``multi`` mode (the block-SpMM benchmark on a pair-plan file) is not
ported: it waits for the port's benchmark, and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .plan import resolve_device
from .solver import SolveInfo, Solver, solve_mixed

# maxdev gates of the performance report (bench_tfqmrgpu.cu:192)
GATE_F64 = 1e-5
GATE_F32 = 2e-4


def load_problem(path: str, echo: int = 0):
    """Sniff XML against legacy format and parse (the reference's main
    dispatches on the reader, bench_tfqmrgpu.cu:576-584).  Returns (A, B,
    X, tolerance, whether X carries a reference solution)."""
    with open(path, "rb") as fh:
        head = fh.read(64).lstrip()
    if head.startswith(b"<"):
        from .io.xmlio import read_xml

        p = read_xml(path, echo=echo)
        return p.a, p.b, p.x, p.tolerance, p.x_has_reference
    from .io.legacy import read_legacy

    p = read_legacy(path, echo=echo)
    return p.a, p.b, p.x, p.tolerance, p.x.data is not None


@dataclasses.dataclass
class TfqmrRun:
    """What one ``run_tfqmr`` measured."""

    rc: int                       # 0 when maxdev passed the gate
    info: SolveInfo               # the first solve's
    maxdev: Optional[float]       # against the reference solution
    gate: float
    first_ms: float               # the first solve ('m': set-up included)
    best_ms: float                # the best of nrep solves


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_tfqmr(path: str, precision: str = "z", nrep: int = 1,
              max_iterations: int = 200, engine: str = "auto",
              echo: int = 1, device=None) -> TfqmrRun:
    """The full-solver benchmark (reference: benchmark_tfQMRgpu_library,
    bench_tfqmrgpu.cu:35-222), on ``device`` (the CUDA card unless given)."""
    if precision not in ("z", "c", "m"):
        raise ValueError(f"precision must be z, c or m, got {precision!r}")
    device = resolve_device(device)
    a, b, x, tolerance, has_ref = load_problem(path, echo=echo)
    tolerance = tolerance or 1e-9
    x_ref = x.data
    lm = a.data.shape[1]
    ln = b.data.shape[2]
    if echo > 0:
        print(f"# problem: mb={a.nrows} nnzbA={a.nnzb} nnzbX={x.nnzb} "
              f"nnzbB={b.nnzb} LM={lm} LN={ln} tol={tolerance}")

    if precision == "m":
        def run():
            xs, info = solve_mixed(a, x, b, tolerance=tolerance,
                                   max_iterations=max_iterations,
                                   engine=engine, echo=echo, device=device)
            return xs.data, info
    else:
        t0 = _clock(device)
        solver = Solver(a, x, b, precision=precision, engine=engine,
                        echo=echo, device=device)
        if echo > 0:
            print(f"# plan + setup in {_clock(device) - t0:.2f} s "
                  f"(engine {solver.engine})")

        def run():
            info = solver.solve(tolerance=tolerance,
                                max_iterations=max_iterations)
            return solver.get_matrix("X"), info

    t0 = _clock(device)
    got, info = run()
    first_ms = (_clock(device) - t0) * 1e3

    gate = GATE_F32 if precision == "c" else GATE_F64
    ok, maxdev = True, None
    if has_ref and x_ref is not None:
        dev = np.abs(got - x_ref)
        maxdev = float(dev.max())
        scale = np.maximum(np.abs(x_ref), 1e-300)
        if echo > 0:
            print(f"# deviation from reference solution: max {maxdev:.3e} "
                  f"avg {float(dev.mean()):.3e} maxrel "
                  f"{float((dev / scale).max()):.3e}")
        ok = maxdev < gate
        if not ok:
            print(f"# maxdev {maxdev:.3e} exceeds {gate} -- "
                  "no performance report")

    print(f"# converged: status={info.return_status} "
          f"iterations={info.iterations_needed} "
          f"residuum={info.residuum_reached:.3e}")
    if info.refinement is not None:
        r = info.refinement
        print(f"# mixed: c stage on {r['c_engine']} {r['c_iterations']} "
              f"iterations (residuum {r['c_residuum']:.3e}), "
              f"{r['rounds']} refinement rounds, 'z' fallback "
              f"{'ran' if r['fallback'] else 'not needed'}")

    best = first_ms
    if ok:
        for _ in range(max(0, nrep - 1)):
            t0 = _clock(device)
            run()
            best = min(best, (_clock(device) - t0) * 1e3)
        tflops = info.flops_performed / best / 1e9
        print(f"# solve: {best:.1f} ms, {info.flops_performed:.3e} flop "
              f"-> {tflops:.3f} TFlop/s ({precision})")
    return TfqmrRun(rc=0 if ok else 1, info=info, maxdev=maxdev, gate=gate,
                    first_ms=first_ms, best_ms=best)


def bench_tfqmr(path: str, precision: str = "z", nrep: int = 1,
                max_iterations: int = 200, engine: str = "auto",
                echo: int = 1, device=None) -> int:
    """``run_tfqmr``'s exit code: 0 when maxdev passed the gate."""
    return run_tfqmr(path, precision, nrep, max_iterations, engine, echo,
                     device).rc


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    mode = args.pop(0)

    def pop(default, cast=str):
        return cast(args.pop(0)) if args else default

    if mode.lower() in ("tfqmr", "solve"):
        path = pop("FD_example.xml")
        precision = pop("z")
        nrep = pop(1, int)
        maxiter = pop(200, int)
        return bench_tfqmr(path, precision, nrep, maxiter,
                           engine=os.environ.get("TFQ_ENGINE", "auto"),
                           device=os.environ.get("TFQ_DEVICE") or None)
    if mode.lower() == "multi":
        print("the 'multi' mode (block-SpMM benchmark on a pair-plan file) "
              "is not ported; it waits for the port's benchmark")
        return 2
    print(f"unknown mode {mode!r}; use tfQMR")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

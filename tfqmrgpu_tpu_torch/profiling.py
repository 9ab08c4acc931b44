"""Observability: trace ranges, flop and byte accounting, roofline audit.

Counterpart of ``tfqmrgpu_tpu/profiling.py``.  The reference instruments
its phases with NVTX PUSH_RANGE/POP_RANGE markers gated by -DUSE_NVTX
(tfqmrgpu.hxx:8-27, used at tfqmrgpu_core.hxx:29,177,332) and counts
analytic flops for getInfo (tfqmrgpu_core.hxx:133-138).  Here:

* ``trace(name, device)`` -- a ``torch.profiler.record_function`` range,
  and on a CUDA device also an NVTX range, when ``TFQ_TRACE`` is set (the
  USE_NVTX analogue); a cheap no-op otherwise.  ``Solver.solve`` opens
  ``tfq.solve.<engine>`` around its dispatch;
* ``start_trace`` / ``stop_trace`` -- a ``torch.profiler`` run over the
  CPU and the card, written as a Chrome trace;
* ``calibrate_hbm`` -- the sustained read+write rate of a chain of adds;
* ``solver_roofline`` / ``timed_solve`` -- the analytic flops and bytes of
  one tfQMR iteration per engine and layout, and the share of that
  ceiling a measured iteration reaches, against ``DEVICE_PEAKS``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch

from .errors import Status, TfqmrgpuError, encode_status

# Peak rates by device kind (``device_kind``).  The H100 row is NVIDIA's
# data sheet for the SXM part at 700 W: 'z' runs K1 on the FP64 tensor
# cores and 'c' in 'highest' runs K2 and K3 as exact FP32 FMAs (TF32 is
# refused), so both peak at 67 TFlop/s; the bf16 split modes of 'c' run K2
# and K3 on the BF16 tensor cores, 989 TFlop/s dense, over the mode's bf16
# products (1, 3, 4 or 6 a float32 product); the oz kernel of 'z' under
# TFQ_PAIRS_Z_OZ runs p(p+1)/2 slice products a float64 product on the
# INT8 tensor cores, 1979 TOPS dense ('xi8'), or on the BF16 ones ('ozc',
# 'oz'); HBM3 3.35 TB/s; 50 MB of L2.
# The "cpu" row is the JAX package's CPU row as its solver_roofline reads
# it (1 TFlop/s of bf16, over 40 for 'z' and over ``mm_passes``, 6 by
# default, for 'c'; 50 GB/s) with its 72 MB residency budget; it has no
# INT8 rate, and prices 'xi8' at its bf16 rate.  A device without a row
# has no ceiling here.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(fp64_tflops=67.0, fp32_tflops=67.0,
                                  bf16_tflops=989.0, int8_tops=1979.0,
                                  hbm_gbps=3350.0, l2_mb=50),
    "cpu": dict(fp64_tflops=1.0 / 40, fp32_tflops=1.0 / 6, bf16_tflops=1.0,
                hbm_gbps=50.0, l2_mb=72),
}
H100 = "NVIDIA H100 80GB HBM3"

# a fused iteration reads and writes the 7 persistent complex vectors (v1,
# v4..v9, tfqmrgpu_core.hxx:49-56) once and reads the shadow v3: about 15
# traversals of one X-shaped vector (the JAX package's fusion lower bound)
VECTOR_PASSES = 15
RESIDENT_VECTORS = 10


def device_kind(device) -> str:
    """The ``DEVICE_PEAKS`` key of ``device``: the card's name, or "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_peaks(kind: str) -> dict:
    """The peak rates of the device kind ``kind``; raises for a device
    without a row, since a ceiling taken from another device would hide
    the one that ran."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise TfqmrgpuError(
            encode_status(Status.NO_IMPLEMENTATION),
            f"no peak rates for {kind!r}: add its data sheet's row to "
            "profiling.DEVICE_PEAKS") from None


# ------------------------------------------------------------------ ranges

def _enabled() -> bool:
    return os.environ.get("TFQ_TRACE", "0") != "0"


@contextlib.contextmanager
def trace(name: str, device=None):
    """A trace range (NVTX PUSH/POP equivalent): a ``record_function``
    range, which ``torch.profiler`` records, and on a CUDA ``device`` an
    NVTX range.  A cheap no-op when TFQ_TRACE is unset."""
    if not _enabled():
        yield
        return
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


_running: Optional[tuple] = None        # (profile, log_dir) of start_trace


def start_trace(log_dir: str):
    """Start a ``torch.profiler`` profile over the CPU and, where there is
    one, the card; ``stop_trace`` writes it to ``log_dir``."""
    global _running
    if _running is not None:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _running = (prof, log_dir)


def stop_trace() -> str:
    """Stop the profile and write its Chrome trace; returns the path."""
    global _running
    if _running is None:
        raise RuntimeError("no trace is running")
    prof, log_dir = _running
    _running = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"tfq_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


# ------------------------------------------------------------- HBM rate

def _timed(fn, device: torch.device) -> tuple:
    """(``fn()``, its seconds): CUDA events after a synchronize on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def calibrate_hbm(size_mb: int = 512, nrep: int = 8, device=None) -> float:
    """The sustained read+write rate (GB/s) of a chain of ``nrep`` passes
    ``y = a + c`` over a float32 tensor of ``size_mb`` MiB, ``c`` a
    different constant each pass, ended by a host read of ``y``; best of 2
    after a warm-up.  Sets TFQ_HBM_GBPS for this process, which
    ``solver_roofline`` then takes as the bandwidth.  On the card unless
    ``device`` is given.

    The JAX package reads each ``c`` from the previous pass's result, which
    XLA fuses.  Here ``c`` is a host constant: a device scalar is a stride-0
    operand, which keeps PyTorch's elementwise kernel off its vectorized
    loads and below the card's rate (``tools.elementwise_rate`` of this
    package times both; PERF.md has the numbers).  Eager PyTorch runs
    every pass it is given, and the host read waits for the last."""
    from .plan import resolve_device

    dev = resolve_device(device)
    a = torch.ones(size_mb * (1 << 20) // 4, dtype=torch.float32, device=dev)
    y = torch.empty_like(a)

    def chain(c0: float):
        for k in range(nrep):
            torch.add(a, c0 + k, out=y)
        return float(y[0])

    chain(1.0)                                       # warm-up
    best = min(_timed(lambda: chain(2.0 + i), dev)[1] for i in range(2))
    gbps = a.numel() * 4 * 2 / 1e9 / (best / nrep)
    os.environ["TFQ_HBM_GBPS"] = f"{gbps:.1f}"
    return gbps


# ------------------------------------------------------------- roofline

@dataclasses.dataclass
class Roofline:
    """Analytic cost model of one tfQMR iteration, and the measured
    efficiency."""

    flops_per_iteration: float      # nominal (reference accounting)
    bytes_per_iteration: float      # engine-specific device-memory traffic
    device_kind: str
    peak_tflops: float              # the precision's compute ceiling
    peak_gbps: float
    compute_bound: bool
    light_speed_s: float            # max(flop/peak, bytes/bw) per iteration
    measured_s: Optional[float] = None
    fraction_of_light: Optional[float] = None
    nnz_mac_per_s: Optional[float] = None
    vectors_resident: bool = False  # ten state vectors fit the L2
    # against the data sheet's bandwidth, whatever TFQ_HBM_GBPS says
    fraction_of_sheet_light: Optional[float] = None

    def __str__(self):
        s = (f"roofline[{self.device_kind}]: "
             f"{self.flops_per_iteration:.3e} flop + "
             f"{self.bytes_per_iteration:.3e} B/iter"
             f"{' (state L2-resident)' if self.vectors_resident else ''}, "
             f"light-speed {self.light_speed_s*1e6:.1f} us "
             f"({'compute' if self.compute_bound else 'bandwidth'}-bound)")
        if self.fraction_of_light is not None:
            s += (f"; measured {self.measured_s*1e6:.1f} us = "
                  f"{100*self.fraction_of_light:.1f}% of light")
        return s


def _vector_bytes(solver, rsize: int) -> int:
    """Bytes of one X-shaped vector in the solver's layout: (re, im) block
    lists or panels, or the packed engine's fused panel (G lane blocks a
    cell, absent lanes included), measured on its shadow vector v3."""
    v = solver._v3
    n = v.numel() if torch.is_tensor(v) else sum(t.numel() for t in v)
    return n * rsize


def _a_bytes(solver, rsize: int) -> int:
    """Bytes of A that one multiply reads: in a split mode K2 and K3 read
    the A panels as 1, 2 or 3 bf16 planes, the oz kernel its p slice
    planes (int8 or bf16)."""
    plan, lm = solver.plan, solver.lm
    if solver.engine == "dense":
        nr = plan.nrows * lm
        return 2 * nr * nr * rsize
    oz = _oz_multiply(solver)
    if oz is not None:
        return oz.planes.numel() * oz.planes.element_size()
    products = _split_products(solver)
    esize = 4 if products is None else 2 * {1: 1, 3: 2, 4: 2, 6: 3}[products]
    if solver.engine == "pallas":              # K3's row-tile panels
        p = solver._pack
        return 2 * p.ntiles * p.r_tile * lm * p.ku * lm * esize
    if solver._packed:                         # K2's packed panels
        p = solver._pp_plan                    # (at LM' when merged)
        return 2 * p.ntiles * p.r_tile * p.lm * p.ku * p.lm * esize
    return plan.nnzb_a * 2 * lm * lm * rsize   # the block list


def _oz_multiply(solver):
    """The solver's ``OzPairPanelMultiply`` (packed 'z' under
    TFQ_PAIRS_Z_OZ), or None."""
    from .ops.pairpanel import OzPairPanelMultiply

    mult = getattr(solver, "_multiply", None)
    return mult if isinstance(mult, OzPairPanelMultiply) else None


def _split_products(solver) -> Optional[int]:
    """The bf16 products a float32 product takes in the mode the solver's
    K2 or K3 runs, or None for exact FP32."""
    from .ops.pairpanel import SPLIT_PRODUCTS

    mode = getattr(getattr(solver, "_multiply", None), "mode", "highest")
    return SPLIT_PRODUCTS.get(mode)


def solver_roofline(solver, measured_iteration_s: Optional[float] = None,
                    mm_passes: Optional[int] = None) -> Roofline:
    """Audit a Solver's per-iteration cost against its device's peaks.

    ``mm_passes`` is the number of bf16 products a float32 product of 'c'
    takes (1, 3, 4 or 6 for 'bf16', 'bf16x3', 'bf16x4', 'bf16x6'): the
    compute ceiling is then the device's bf16 peak over it (on the "cpu"
    row the JAX package's value, 1 TFlop/s over ``mm_passes``).  The oz
    kernel of 'z' (TFQ_PAIRS_Z_OZ) takes p(p+1)/2 slice products a float64
    product, at the INT8 peak in 'xi8' and the BF16 peak in 'ozc' and 'oz'.
    It is the mode the solver's kernel runs: left at None it is worked out
    from that mode, and a value that contradicts it (any value where the
    kernel runs exact FP32 or FP64) raises ValueError.  Exact FP32 takes
    the FP32 peak.  (The JAX package's ``mm_passes`` counts MXU passes, 6 for its
    exact FP32, and prices any value it is given; on the H100 exact FP32
    is no bf16 product.)

    Flops are the reference's accounting (``core.flops_per_iteration``).
    Bytes are two reads of A as the engine holds it, plus
    ``VECTOR_PASSES`` passes over one X-shaped vector unless ten of them
    fit the L2, when the vector passes count nothing: a ceiling must lie
    below any real iteration, so a fraction above 1 is a fault of the
    count.  The bandwidth is TFQ_HBM_GBPS when set (``calibrate_hbm``),
    else the data sheet's; ``fraction_of_sheet_light`` always takes the
    data sheet's."""
    from .core import flops_per_iteration

    plan = solver.plan
    lm, ln = solver.lm, solver.ln
    rsize = 8 if solver.precision == "z" else 4
    flops = flops_per_iteration(plan.n_pairs, plan.nnzb_x, lm, ln)
    kind = device_kind(solver.device)
    peaks = device_peaks(kind)
    nvec = _vector_bytes(solver, rsize)
    vectors_resident = RESIDENT_VECTORS * nvec <= (peaks["l2_mb"] << 20)
    vec_passes = 0 if vectors_resident else VECTOR_PASSES
    bytes_ = 2 * _a_bytes(solver, rsize) + vec_passes * nvec

    oz = _oz_multiply(solver)
    if oz is not None:
        runs = oz.p * (oz.p + 1) // 2
    else:
        runs = None if solver.precision == "z" else _split_products(solver)
    if mm_passes is not None and mm_passes != runs:
        raise ValueError(
            f"mm_passes={mm_passes}, but the solver's kernel runs "
            + (f"{runs} slice products" if oz is not None
               else "FP64" if solver.precision == "z" else "exact FP32"
               if runs is None else f"{runs} bf16 products"))
    mm_passes = runs
    if oz is not None:
        rate = (peaks.get("int8_tops", peaks["bf16_tflops"]) if oz.xi8
                else peaks["bf16_tflops"])
        peak_tflops = rate / mm_passes
    elif solver.precision == "z":
        peak_tflops = peaks["fp64_tflops"]
    elif mm_passes is None:
        peak_tflops = peaks["fp32_tflops"]
    else:
        peak_tflops = peaks["bf16_tflops"] / mm_passes
    hbm_gbps = float(os.environ.get("TFQ_HBM_GBPS", peaks["hbm_gbps"]))
    t_compute = flops / (peak_tflops * 1e12)
    t_bw = bytes_ / (hbm_gbps * 1e9)
    light = max(t_compute, t_bw)
    light_sheet = max(t_compute, bytes_ / (peaks["hbm_gbps"] * 1e9))
    r = Roofline(
        flops_per_iteration=flops, bytes_per_iteration=bytes_,
        device_kind=kind, peak_tflops=peak_tflops, peak_gbps=hbm_gbps,
        compute_bound=t_compute >= t_bw, light_speed_s=light,
        vectors_resident=vectors_resident)
    if measured_iteration_s is not None:
        r.measured_s = measured_iteration_s
        r.fraction_of_light = light / max(measured_iteration_s, 1e-30)
        r.fraction_of_sheet_light = (light_sheet
                                     / max(measured_iteration_s, 1e-30))
        r.nnz_mac_per_s = (plan.n_pairs * lm * lm * ln
                           / measured_iteration_s / 2)
    return r


def timed_solve(solver, tolerance: float = 1e-6, max_iterations: int = 999,
                repeats: int = 2):
    """One warm-up solve, then ``repeats - 1`` timed ones (one with the
    default 2): CUDA events after a synchronize on the card, the host
    clock on the CPU.  Returns (info, best seconds, ``solver_roofline`` at
    best / iterations)."""
    info = solver.solve(tolerance=tolerance, max_iterations=max_iterations)
    best = None
    for _ in range(max(0, repeats - 1)):
        info, dt = _timed(lambda: solver.solve(
            tolerance=tolerance, max_iterations=max_iterations),
            solver.device)
        best = dt if best is None else min(best, dt)
    if best is None:
        best = float("nan")
    iters = max(info.iterations_needed, 1)
    return info, best, solver_roofline(solver, best / iters)

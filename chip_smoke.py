"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``tfqmrgpu_tpu_torch/csrc`` (one nvcc
per source, in parallel) and runs these phases in order, printing a line or
two for each:

1. the device: the card's name and power limit, the CUDA version, the
   kernel build time;
2. the pair-plan kernel K1 against its plain PyTorch version on the card,
   at all 15 allowed block sizes in 'z' and 'c' ('z' also under every warp
   grid of its tile schedule) and on the golden-class plan (maxdev <= 1e-12
   for 'z', <= 1e-4 for 'c', relative to the largest entry; the same bits
   on a repeated launch); at the golden class the schedule's tile (R x W
   blocks), the bytes it stages per multiply, K1's time, TFlop/s and share
   of the bound, the plain version's time and the library yardstick (a
   complex128 BSR ``torch.sparse.mm``); at the FD shape K1's device time
   (``torch.profiler``) and the dispatch-bound times of K1 and the plain
   version;
3. the FD rtb=12.75 'z' solve through ``bsrsv_z`` on the card, twice: it
   must converge to 1e-9, match the generator's dense reference to 1e-5,
   send every multiply through K1 and repeat its iteration count;
4. the golden-class 'z' solve through ``Solver(engine='auto')``, checked by
   an independent residual |A X - B| / |B| < 1e-8, and its time per
   iteration over 20 fixed iterations;
5. the row-tile kernel K3 against its plain version at all 15 block sizes
   with r_tile 1 and 4, at the shapes its staged design adds (wide planes
   of 81, 65 and 70 columns, which take the 4-byte copy branch; 1, 2, 4 and
   8 tiles side by side in a unit; an x that is not 16-byte aligned; work
   lists dealt to 1, 7 and units/2 CTAs: all the same bits), and on the
   golden-class plan with cos/sin data (maxdev <= 1e-4), the same bits on a
   repeated launch, and K3's device time, back-to-back time and
   single-call median, the plain version's and the library call's
   (complex64 BSR) times;
6. the golden-class 'c' solve through ``Solver(engine='auto')``, which
   must take the row-tile engine (r_tile 2, ku 12), converge to 1e-5 with
   every multiply through K3, and pass an independent float64 residual
   |A X - B| / |B| < 1e-4 over X's pattern; its time per iteration over 10
   fixed iterations;
7. the dense engine: FD rtb=6.75 'z' through ``bsrsv_z``, which 'auto'
   sends to 'dense': converged to 1e-9 and within 1e-5 of the generator's
   dense reference;
8. the stream probe K4 (``tfqmrgpu_tpu_torch.dma_probe.sweep``) over stage
   sizes and operand counts, each held against its plain version, with
   the ``copy_`` yardstick;
9. the packed pair-plan kernel K2 against its plain version on random
   plans at all 15 block sizes x column groups (1, 2) x r_tile (1, 2), at
   512 lanes per plane, at the added shapes of phase 5, and on the FD
   rtb=12.75 fine pack (maxdev <= 1e-4, the same bits on a repeated
   launch), and at the golden class with cos/sin data at G = 1, 2, 4, 8:
   K2's device, back-to-back and single-call times and the plain
   version's, the G the solver's rule picks and the fastest G; beside them
   K1 in 'c' on the plain pair table and the library call (complex64 BSR);
10. the golden-class 'c' solve through ``Solver(engine='pairs')``, which
   must pack with G = 8, converge to 1e-5 with every multiply through K2
   and pass the independent float64 residual < 1e-4; its time per
   iteration over 10 fixed iterations;
11. FD rtb=12.75 through ``bsrsv_c`` (tolerance 1e-5, at most 2000
   iterations): 'auto' takes the packed 'pairs' engine, on the fine pack
   at G = 1 or, where the card's rates (``ops/rates.py``) say it pays, on
   the superblock (f = 2 or 4 block rows merged, LM' = 8f, 8 lanes: the
   phase checks the merged pack), every multiply goes through K2 and X is
   finite; status, iterations, residuum, maxdev against the dense
   reference and wall are printed, not gated;
12. the file path: FD rtb=12.75 written by ``io.xmlio.write_xml`` and run
   through the parity CLI (``bench.run_tfqmr``, at most 2000 iterations):
   'z' must pass the 1e-5 gate against the embedded reference with
   2 K1 launches an iteration and one a probe; 'm' (``solve_mixed``) must
   reach 1e-9 with its c stage on the packed 'pairs' engine (K2, phase
   11's pack) and one K1 launch per float64 residual (plus the 'z'
   fallback's, if it ran);
13. golden-class 'm' through ``bsrsv_m`` with complex128 data: the c stage
   on the row tiles (K3), SUCCESS at 1e-9, an independent float64 residual
   over X's pattern below 1e-8, one K1 launch per float64 residual;
14. FD rtb=12.75 'z' through ``Solver.solve_checkpointed`` in chunks of 25
   with a state file: cut after one chunk, resumed in a new Solver, which
   must converge to 1e-9, remove the state file and match the reference
   to 1e-5;
15. the C API: ``libtfqmrgpu_tpu_torch.so`` built with g++ and called by
   ctypes in this process: (a) FD rtb=12.75 through ``tfqmrgpu_bsrsv_z``
   (phase 3's iterations, every multiply through K1, maxdev < 1e-5), (b)
   the golden-class 'z' system through the ten-step workflow (X equal to
   ``Solver(engine='auto')``'s with the C path's v3 to 1e-12, every
   multiply through K1, ``bufferSize`` beside the peak device memory), (c)
   golden-class 'c' through ``tfqmrgpu_bsrsv_c`` (every multiply through
   K3, residual < 1e-4), (d) golden-class 'm' through ``tfqmrgpu_bsrsv_m``
   (SUCCESS, residual < 1e-8, one K1 launch per float64 residual, the c
   stage on K3), each C path's wall beside the Python path's; (e) the C
   example built with gcc and run as its own process, whose embedded
   interpreter imports the port and solves on the card;
16. the sharded layer (``tfqmrgpu_tpu_torch.parallel``) at world size 1 on
   NCCL (one card; the multi-rank semantics are held by the gloo tests on
   the CPU): (a) FD rtb=12.75 'z' through ``sharded_solve`` (K1 per shard:
   phase 3's iterations and K1 launches, X within 1e-10 of phase 3's), (b)
   golden-class 'c' through ``solve_sharded(engine='auto')`` -> 'rowtile'
   (K3; within one iteration of phase 6, residual < 1e-4), (c)
   golden-class 'm' through ``solve_sharded(precision='m')`` (converged to
   1e-9, residual < 1e-8, K3 in the c stage, one K1 launch per float64
   residual), (d) FD rtb=6.75 'z' through ``ShardedPanelSolver`` (phase
   7's iterations), each with its collectives checked and printed per
   iteration and its wall; (e) the sharded example as its own process
   (row tiles, packed pairs and 'm'), run after phase 17;
17. the sharded packed-pairs engine (``parallel/sharded_pairs.py``, K2 per
   shard) at world size 1 on phase 16's process group: (a) the golden-class
   'c' system of phase 10 through ``solve_sharded(engine='pairs')``, every
   tile local (phase 10's iterations, probes and K2 launches, X equal to
   phase 10's to the bit), (b) the same through
   ``ShardedPairsSolver(overlap=False)``, every tile remote and read
   through the asynchronous all_gather (X equal to (a)'s to the bit), (c)
   golden 'm' through the packed pairs (c stage on K2, float64 residuals on
   K1, converged to 1e-9, residual < 1e-8), (d) the golden-class pattern
   with 48 block columns, whose X panel passes the row tiles' limit,
   through ``solve_sharded(engine='auto')`` -> 'pairs' (residual < 1e-4
   over X's pattern; the iterations and X of ``Solver(engine='pairs')`` to
   the bit), each with its collectives checked; (e) the comm
   model (``parallel/comm_model.py``) for the golden class at pr 1, 2, 4
   and 8, from layouts alone;
18. the measurement and tuning layer (``profiling``, ``autotune``), after
   phase 16 (e): (a) ``calibrate_hbm`` (a chain of adds over 512 MiB; its
   GB/s beside K4's and ``copy_``'s from phase 8, at most 1.05 x the data
   sheet's 3.35 TB/s), (b) the golden-class 'c' row-tile solve under
   ``torch.profiler`` with TFQ_TRACE=1 (one ``tfq.solve.pallas`` range
   holding every K3 kernel the profile kept) and unset (no range), (c)
   ``timed_solve`` and ``solver_roofline`` on FD rtb=12.75 'z' (K1), golden
   'z' (K1), golden 'c' row tiles (K3) and packed pairs (K2): phases 3, 4,
   6 and 10's iterations, flops and bytes an iteration, light speed and the
   fractions of light and of sheet light, each in (0, 1.05], from the
   best of two timed solves, (d)
   ``autotune_solver`` on the golden class in 'c' and 'z' with a fresh
   cache under ``build/``: every row printed, every candidate on a
   hand-written kernel timed with its counter raised (and no counter
   raised by 'dense' or 'xla'), the winner's solve equal to a Solver built
   directly with the winning engine and environment (iterations, X to the
   bit), and a second call a cache hit that launches nothing; then the
   local search from a lone packed 'pairs' candidate (its G and r_tile
   moves, every search row timed on K2);
19. the small-block layer (``ops/superblock.py``, ``ops/rates.py``,
   ``tools/blocksize_sweep.py``): (a) the block-size sweep: K2 and K3 in
   'c' and K1 in 'z' at the 15 block sizes on the golden-class plan, and
   the oz kernel's whole 'z' multiply at (4, 4), (8, 8), (16, 32) and (32,
   32), each held against the float64 product (maxdev <= 1e-4 'c', <= 1e-12
   'z', the oz rows of the largest entry of |A|.|X|; the same bits on a
   repeat), every row printed, K2's rates at LM 4, 8, 16
   and 32 beside ``rates.py``'s, and the factor ``auto_f_row`` picks from
   each; (b) the golden-class pattern at (LM, LN) = (8, 8) and (4, 8) in
   'c' through ``Solver(engine='pairs')`` with cos/sin-dominant data at
   TFQ_SOLVER_SUPER = 0, 2, 4 (and 8 at LM 4): the merged pack, K2 on it
   against its plain version (maxdev <= 1e-4, the same bits on a repeat)
   and its time, convergence to 1e-5 with every multiply through K2 at
   LM f*LM, the float64 residual < 1e-4 over X's pattern, iterations
   within 3 of the fine solve, ms an iteration (CUDA events) beside the
   fine solve's, and what 'auto' picks; (c) FD rtb=12.75 'm' through
   ``solve_mixed(engine='pairs')`` with the c stage at TFQ_SOLVER_SUPER=0,
   2 and 4 (LM' 16 and 32 on 8 lanes): K2 on the pack against its plain
   version and its device time,
   converged to 1e-9, one K1 launch per float64 residual, the c stage's
   K2 launches, the iterations beside phase 12's; (d) ``autotune_solver``
   at the golden class (8, 8) in 'c' with a fresh cache: the superblock
   candidates are rows, each timed with K2's counter raised;
20. the reduced-precision layer (the bf16 split modes of K2 and K3 on the
   BF16 tensor cores, ``ops/ozaki.py``), run after phase 17 on phase 16's
   process group: (a) K3 in bf16x3, bf16x4 and bf16x6 against its plain
   version at the 15 block sizes x r_tile (1, 4) and the staged shapes of
   phase 5 (maxdev <= 1e-5, the same bits on a repeat, from a misaligned
   x and from other work lists), 'bf16' through the FP32 K3 with the bits
   of 'highest', and at the golden class with cos/sin data per mode: the
   maxdev against the float64 product (bf16x6 <= 1e-4, the others at most
   1.05 times their plain version's, which tells bf16x4 from bf16x3),
   device, back-to-back and single-call
   times, the plain time and the bound (the mode's bf16 products at the
   data sheet's BF16 rate), beside phase 5's 'highest'; (b) K2 in bf16,
   bf16x3, bf16x4 and bf16x6 the same way at the six sizes with LM >= 16 x
   G (1, 2), on a merged (8, 8) pack at LM' 16 and at the golden class at
   G 8, beside phase 9's; (c) golden 'c' through ``Solver(engine='auto')``
   -> 'pallas' under TFQ_PALLAS_MM_PREC and ``Solver(engine='pairs')`` (G
   8) under TFQ_PAIRS_MM_PREC, each in bf16x3 and bf16x6: converged to
   1e-5 with every multiply through the split kernel, the float64
   residual < 1e-3 (bf16x3) or < 1e-4 (bf16x6), ms an iteration over 10
   (CUDA events) beside phases 6 and 10; (d) golden 'm' through
   ``bsrsv_m`` under TFQ_PALLAS_MM_PREC=bf16x3: SUCCESS at 1e-9, float64
   residual < 1e-8, the c stage on the split K3 and one K1 launch a float64
   residual, rounds beside phase 13's; (e) golden 'z' through 'xla' under
   TFQ_XLA_OZ=1 and FD rtb=6.75 'z' through 'dense' under TFQ_Z_OZAKI=1:
   the native solve's iterations, X within 1e-10 of it (FD, which stops at
   1e-9: within 1e-9), the residual < 1e-8, and both walls; for FD also
   the residuum of both solves after 60 and 100 iterations with no stop,
   where each has stagnated; (f)
   ``ShardedPairsSolver(precision='bf16x6')`` and
   ``ShardedRowTileSolver(mm_prec='bf16x3')`` at world size 1 on golden
   'c': (c)'s iterations and X to the bit.  Phase 18 (c) also times the
   golden 'c' row tiles in bf16x3 against ``solver_roofline``'s BF16
   ceiling over 3 products (``mm_passes``);
21. K1's Ozaki modes on the oz kernel (``csrc/pairpanel_oz.cu``) and the
   JAX package's packed 'z' route under TFQ_PAIRS_Z_OZ=1, run last: (a)
   the kernel against its plain version to the bit, and on a repeat, in
   each body ('xi8', 'ozc' with bf16 or int8 A, the mixed fallback, legacy
   'oz' with int8 or bf16 A) at the kernel block sizes with LM >= 16 x G
   (1, 2) x r_tile (1, 2) on wide-exponent data with lanes outside
   float32's range, and each body at its depth bound (every slice int at
   full scale and positive); (b) the golden class per body ('z' rule's
   G 8): maxdev against the float64 product <= 1e-12, device time
   (``torch.profiler``), back-to-back and single-call times, the whole
   multiply's time, the plain version's, the bound (the body's slice
   products at the data sheet's INT8 or BF16 rate against the A and X
   slices and the output), beside phase 2's K1 and library call; (c)
   golden 'z' through ``Solver(engine='pairs')`` under TFQ_PAIRS_Z_OZ=1
   ('xi8'): phase 4's iterations, every multiply through the oz kernel, X
   within 1e-10 of phase 4's, the float64 residual < 1e-8, ms an iteration
   over 10 (CUDA events); (d) FD rtb=12.75 'z' under it at
   TFQ_SOLVER_SUPER 'auto', 2 and 4: converged to 1e-9 within 2 of phase
   3's iterations with X within 1e-9, or, as the JAX route does on FD,
   stopped at ``OZ_FD_CAP`` iterations with the residuum and X within
   ``OZ_FD_FLOOR``; every multiply through the oz kernel where the engine
   is 'pairs'; (e) phase 19 (a)'s 'z' rows beside ``ops/rates.py``'s.

Then one JSON line on the kernels (time, launches on their path, bound,
plain and library times; the launches of every path that runs the kernel
under ``launches_by_path``; for K1 also the bytes staged, for K2 and K3
also ``kernel_ms`` and ``burst_ms``, for K2 ``merged_ms``, its device
time on phase 19's plans; the split kernels ``rowtile_spmm_bf16`` and
``pairpanel_tiles_bf16`` head with bf16x3, their ``launches`` phase 20
(c)'s bf16x3 solve's, and give every mode under ``modes``; the oz kernel
``pairpanel_oz`` heads with 'xi8', its ``launches`` phase 21 (c)'s, every
body under ``modes``) and, last, one JSON line on the device.
K1's times in phase 2 are CUDA events around 20 calls issued back to back
(``burst_ms`` for K2 and K3); ``kernel_ms`` is the kernel's device time
from ``torch.profiler``; phase 19's kernel times are CUDA events around 20
calls queued behind a spin kernel (``blocksize_sweep.time_ms``: device
time, no host dispatch); every other time is the median of 20 single
calls, each timed with CUDA events.  Any failed check raises, and the
script exits non-zero.  It needs CUDA and runs nothing on the CPU in its
place.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch


def require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float,
          rate: str = "fp32_tflops") -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the device-memory rate and the operations over the peak ``rate`` of
    the data sheet (``profiling.DEVICE_PEAKS``)."""
    from tfqmrgpu_tpu_torch.profiling import DEVICE_PEAKS, H100

    peaks = DEVICE_PEAKS[H100]
    t_bytes = nbytes / (peaks["hbm_gbps"] * 1e9)
    t_ops = flops / (peaks[rate] * 1e12)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


# ------------------------------------------------------------- problems

def random_problem(rng, mb: int, lm: int, ln: int, ncols: int):
    """A, X, B patterns with random rows (diagonal + 3 random columns in A;
    about half the rows per X column; B one block per column)."""
    from tfqmrgpu_tpu_torch import Bsr

    cols_a = [sorted({i, *rng.integers(0, mb, 3).tolist()}) for i in range(mb)]
    x_rows = [set(rng.choice(mb, mb // 2, replace=False).tolist()) | {j % mb}
              for j in range(ncols)]
    cols_x = [[j for j in range(ncols) if r in x_rows[j]] for r in range(mb)]
    cols_b = [[j for j in range(ncols) if j % mb == r] for r in range(mb)]

    def bsr(rows, ncol, name):
        rowptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        return Bsr(mb, ncol, rowptr, np.array([c for r in rows for c in r],
                                              dtype=np.int64), None, name)

    return bsr(cols_a, mb, "A"), bsr(cols_x, ncols, "X"), bsr(cols_b, ncols, "B")


def golden_class_patterns(mb: int = 281, deg: int = 11, ncols: int = 16):
    """The banded plan bench.py:63-86 synthesizes when the golden asset is
    absent (49,456 pairs at the defaults): A's row i holds block columns
    i .. i+deg-1 (mod mb), X is full over ncols block columns, and B holds
    the blocks (j, j) (``tools/blocksize_sweep.golden_class_patterns``)."""
    from tfqmrgpu_tpu_torch.tools import blocksize_sweep

    return blocksize_sweep.golden_class_patterns(mb, deg, ncols)


def dominant_fill(rng, nnzb: int, deg: int, lm: int) -> np.ndarray:
    """Random complex A blocks whose diagonal blocks (the first of each row)
    get 2*deg*LM on their diagonal: above the expected sum of a row's
    off-diagonal magnitudes (deg*LM*sqrt(pi/2)), so A is diagonally
    dominant."""
    ad = rng.standard_normal((nnzb, lm, lm, 2)) @ [1, 1j]
    ad[::deg] += 2.0 * deg * lm * np.eye(lm)
    return ad


def cos_sin(nnzb: int, d1: int, d2: int) -> np.ndarray:
    """re = cos(idx), im = sin(idx), idx = (m*d1 + i)*d2 + j
    (fill_cos_sin, bench_tfqmrgpu.cu:276-287)."""
    from tfqmrgpu_tpu_torch.tools import blocksize_sweep

    return blocksize_sweep.cos_sin(nnzb, d1, d2)


def planes(c: np.ndarray, dtype, device) -> tuple:
    return (torch.from_numpy(np.ascontiguousarray(c.real)).to(device, dtype),
            torch.from_numpy(np.ascontiguousarray(c.imag)).to(device, dtype))


def x_panel(plan, lm: int, ln: int, blocks: np.ndarray, dtype, device):
    """X-shaped complex blocks as (re, im) [mb*LM, ncc, LN] panels."""
    from tfqmrgpu_tpu_torch.ops.panel import PanelLayout

    plan.lm, plan.ln = lm, ln
    lay = PanelLayout.from_plan(plan)
    return tuple(torch.from_numpy(lay.pack_x(np.ascontiguousarray(p))).to(
        device, dtype) for p in (blocks.real, blocks.imag)), lay


def library_product(plan, a_blocks: np.ndarray, xp: tuple, cdtype,
                    want: tuple, gate: float):
    """One PyTorch call computing the unmasked panel product: A as a
    ``torch.sparse_bsr_tensor`` times the dense X panel [nr, c], checked
    against ``want`` (the kernel's plain version, as panels; X is full on
    the golden-class plan, so the mask changes nothing).  Returns (call,
    None), or (None, why) where PyTorch refuses it on the card.  Timed as a
    yardstick; the port never calls it."""
    dev = xp[0].device
    lm = a_blocks.shape[1]
    nr = plan.nrows * lm
    # BSR wants the columns of a row ascending (banded rows wrap around);
    # the invariants are checked on the host, where a failure raises
    rows = np.repeat(np.arange(plan.nrows), np.diff(plan.rowptr_a))
    order = np.lexsort((plan.colind_a, rows))
    try:
        a = torch.sparse_bsr_tensor(
            torch.from_numpy(plan.rowptr_a),
            torch.from_numpy(plan.colind_a[order]),
            torch.from_numpy(a_blocks[order]).to(cdtype), size=(nr, nr),
            check_invariants=True).to(dev)
        x = torch.complex(xp[0], xp[1]).reshape(nr, -1)
        y = torch.sparse.mm(a, x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    rel, _ = _maxdev((y.real, y.imag), tuple(w.reshape(nr, -1) for w in want))
    require(rel <= gate, f"library product maxdev {rel:.3e} > {gate}")
    return (lambda: torch.sparse.mm(a, x)), None


def riri(c: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Complex blocks [nnzb, d1, d2] -> the C caller's RIRIRIRI array."""
    return np.ascontiguousarray(np.stack([c.real, c.imag], axis=-1),
                                dtype=dtype)


def c_onecall(lib, precision: str, a, x, b, threshold: float,
              max_iterations: int, index_offset: int = 0):
    """``tfqmrgpu_bsrsv_{precision}`` of the port's C library by ctypes, on
    operands with data on A and B (float arrays for 'c', double for 'z' and
    'm').  Returns (status, X complex [nnzbX, LM, LN], iterations,
    residual, host ms of the C call alone: the arrays a C caller holds are
    made before it, X's complex view after it)."""
    import ctypes

    lm, ln = a.data.shape[1], b.data.shape[2]
    dt = np.float32 if precision == "c" else np.float64
    rpa, cia, rpx, cix, rpb, cib = (
        np.ascontiguousarray(np.asarray(v, np.int32) + index_offset)
        for v in (a.rowptr, a.colind, x.rowptr, x.colind, b.rowptr,
                  b.colind))
    amat, bmat = riri(a.data, dt), riri(b.data, dt)
    xmat = np.zeros((x.nnzb, lm, ln, 2), dt)
    iters = ctypes.c_int32(max_iterations)     # in: the cap, out: achieved
    resid = ctypes.c_float(threshold)          # in: the target, out: reached
    t0 = time.perf_counter()
    st = getattr(lib, f"tfqmrgpu_bsrsv_{precision}")(
        a.nrows, lm, ln,
        rpa.ctypes.data, a.nnzb, cia.ctypes.data, amat.ctypes.data, b"n",
        rpx.ctypes.data, x.nnzb, cix.ctypes.data, xmat.ctypes.data, b"n",
        rpb.ctypes.data, b.nnzb, cib.ctypes.data, bmat.ctypes.data, b"n",
        ctypes.byref(iters), ctypes.byref(resid), index_offset, 0)
    ms = (time.perf_counter() - t0) * 1e3
    return (st, xmat[..., 0] + 1j * xmat[..., 1], iters.value, resid.value,
            ms)


# --------------------------------------------------------------- phases

def packed_multiply(plan, lm: int, ln: int, av: np.ndarray, xv: np.ndarray,
                    dev, group: int = 1, r_tile: int = 1, slots: int = None,
                    precision: str = "highest"):
    """PairPanelMultiply (K2) on ``dev`` over the plan's packed pairs at
    column group size ``group`` and ``r_tile`` (its work list dealt to
    ``slots`` CTAs, by default those the card holds at once) in
    ``precision``, the fused X panel of the complex blocks ``xv``, and the
    packed plan."""
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    gp, pplan = pack_plan(plan, lm, ln, group, r_tile)
    a_re, a_im = planes(av, torch.float32, dev)
    mult = pp.PairPanelMultiply(
        pplan, pp.build_a_panels_device(pplan, a_re, a_im), slots=slots,
        precision=precision)
    return mult, fused_x(pplan, gp, xv, torch.float32, dev), pplan


def pack_plan(plan, lm: int, ln: int, group: int = 1, r_tile: int = 1):
    """The packed pairs of a plan at column group size ``group`` (1: none)
    and ``r_tile``: (``GroupedPairs`` or None, ``PairPanelPlan``)."""
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    pairs = plan.pairs.cpu().numpy().astype(np.int64)
    pair_y = np.repeat(np.arange(plan.nnzb_x),
                       np.diff(plan.starts.cpu().numpy()))
    row_of = np.repeat(np.arange(plan.nrows), np.diff(plan.rowptr_x))
    cols = plan.colindx.cpu().numpy().astype(np.int64)
    if group > 1:
        gp = pp.pack_grouped(pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x,
                             ln, group, row_of=row_of, col_of=cols)
        return gp, pp.pack_pair_plan(gp.pair_a2, gp.pair_x2, gp.pair_y2,
                                     gp.nnzb2, gp.nnzb2, lm, gp.ln2,
                                     r_tile=r_tile, row_of=gp.row_of2,
                                     col_of=gp.col_of2)
    return None, pp.pack_pair_plan(pairs[:, 0], pairs[:, 1], pair_y,
                                   plan.nnzb_x, plan.nnzb_x, lm, ln,
                                   r_tile=r_tile, row_of=row_of, col_of=cols)


def fused_x(pplan, gp, xv: np.ndarray, dtype, dev) -> torch.Tensor:
    """The fused permuted X panel of the complex blocks ``xv`` on a packed
    plan (grouped by ``gp`` where given), in ``dtype`` on ``dev``."""
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    npdt = np.float64 if dtype == torch.float64 else np.float32
    xre, xim = (np.ascontiguousarray(v, dtype=npdt)
                for v in (xv.real, xv.imag))
    if gp is not None:
        xre, xim = pp.grouped_blocks(gp, xre), pp.grouped_blocks(gp, xim)
    return torch.from_numpy(pp.permute_x(pplan, xre, xim)).to(dev)


def pattern_residual(p, xc: np.ndarray, a, b, dev) -> float:
    """The independent float64 |A X - B| / |B| over X's pattern of the
    blocks ``xc`` on the plan ``p``, through the plain block-list product
    on the card."""
    from tfqmrgpu_tpu_torch.ops import linalg
    from tfqmrgpu_tpu_torch.ops.blocksparse import spmm_pairs

    xp = planes(xc, torch.float64, dev)
    ax = spmm_pairs(planes(a.data, torch.float64, dev), xp, p.pairs[:, 0],
                    p.pairs[:, 1], p.pair_y(), p.nnzb_x)
    z = torch.zeros_like(xp[0])
    bx = linalg.add_rhs((z, z), planes(b.data, torch.float64, dev), 1.0,
                        p.subset)
    return float(torch.sqrt(((ax[0] - bx[0]) ** 2 + (ax[1] - bx[1]) ** 2).sum()
                            / (bx[0] ** 2 + bx[1] ** 2).sum()))


def golden_c_problem(mb: int = 281, ncols: int = 16, deg: int = 11,
                     lm: int = 32):
    """The golden-class 'c' system of phases 6 and 10: seeded random
    complex64 blocks, A diagonally dominant."""
    rng = np.random.default_rng(282)
    a, x, b = golden_class_patterns(mb, deg, ncols)
    a = a.with_data(dominant_fill(rng, a.nnzb, deg, lm).astype(np.complex64))
    b = b.with_data((rng.standard_normal((b.nnzb, lm, lm, 2)) @ [1, 1j])
                    .astype(np.complex64))
    return a, x, b


def phase_device():
    from tfqmrgpu_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)                 # name, power limit
    _, seconds = _build.build()
    _build.load_kernels()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, kernels built in "
          f"{seconds:.1f} s", flush=True)
    return card


def _maxdev(got, want):
    dev = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return dev / scale, dev


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _burst_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Time of one call (ms): CUDA events around ``reps`` calls issued back
    to back, after ``warm`` calls, so that no call's host dispatch is
    inside unless it outlasts the device work (the FD shape)."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, kernel: str, reps: int = 50, required: bool = True):
    """Mean device duration (ms) of the kernels named ``kernel`` over
    ``reps`` calls, from ``torch.profiler``: the kernel's own time where the
    host dispatch of a call outlasts it.  The trace may lose a few of the
    events; the mean is over those it kept, at least half.  A trace that
    kept fewer is taken again, a second later, up to four traces in all
    (on an H100 the profiler has returned traces with a third of a
    kernel's events, four times in a row late in a run); after that the
    check fails, or where not ``required`` the time is None."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        if attempt:
            time.sleep(1.0)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if reps // 2 <= len(us) <= reps:
            return sum(us) / len(us) / 1e3
    require(not required, f"the profiler saw {len(us)} {kernel} launches "
            f"for {reps} calls")
    return None


def phase_kernel(dev, fd):
    from tfqmrgpu_tpu_torch import ALLOWED_BLOCK_SIZES, create_plan
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    gates = {"z": (torch.float64, 1e-12), "c": (torch.float32, 1e-4)}
    rng = np.random.default_rng(2024)
    worst = {"z": 0.0, "c": 0.0}
    ngrids = 0

    def check(mult, xp, what, gate):
        got = mult(xp)
        again = mult(xp)
        rel, abs_err = _maxdev(got, mult.plain(xp))
        torch.cuda.synchronize()
        require(rel <= gate, f"{what} maxdev {rel:.3e} > {gate}")
        require(all(torch.equal(p, q) for p, q in zip(got, again)),
                f"{what}: repeated launch differs")
        return rel, abs_err

    for lm, ln in ALLOWED_BLOCK_SIZES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=5)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for prec, (dtype, gate) in gates.items():
            ap, xp = planes(av, dtype, dev), planes(xv, dtype, dev)
            # 'z': the rule's tile schedule, then every warp grid of the size
            grids = [None] + (pp.warp_grids(lm, ln) if prec == "z" else [])
            for grid in grids:
                mult = pp.PairPlanMultiply(plan, *ap, ln, grid=grid)
                rel, _ = check(mult, xp, f"({lm},{ln}) '{prec}' grid {grid}",
                               gate)
                worst[prec] = max(worst[prec], rel)
                ngrids += grid is not None

    plan = create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    golden = {}
    for prec, (dtype, gate) in gates.items():
        mult = pp.PairPlanMultiply(plan, *planes(av, dtype, dev), 32)
        xp = planes(xv, dtype, dev)
        golden[prec] = check(mult, xp, f"golden '{prec}'", gate) + (mult, xp)
    print(f"phase 2 kernel vs plain: 15 block sizes ('z' also at {ngrids} "
          f"warp grids), worst maxdev z {worst['z']:.3e} c "
          f"{worst['c']:.3e}; golden-class ({plan.n_pairs} pairs) z "
          f"{golden['z'][0]:.3e} c {golden['c'][0]:.3e}; repeated launches "
          f"bit-identical", flush=True)

    _, abs_err, mult, xp = golden["z"]
    sched = mult.schedule
    ms = _burst_ms(lambda: mult(xp))
    plain_ms = _burst_ms(lambda: mult.plain(xp))
    xpan, lay = x_panel(plan, 32, 32, xv, torch.float64, dev)
    want = tuple(torch.from_numpy(lay.pack_x(y.cpu().numpy())).to(dev)
                 for y in mult.plain(xp))
    lib, why = library_product(plan, av, xpan, torch.complex128, want, 1e-12)
    library_ms = _burst_ms(lib) if lib else None
    flops = plan.n_pairs * 8.0 * 32 ** 3
    bound_ms, bound_by = bound(
        16 * (plan.nnzb_a * 32 * 32 + 2 * plan.nnzb_x * 32 * 32)
        + 4 * (plan.nnzb_x + 1 + 2 * plan.n_pairs), flops, "fp64_tflops")
    fplan = create_plan(fd.a, fd.x, fd.b, device=dev)
    fa = fd.a_with_data().data
    fmult = pp.PairPlanMultiply(fplan, *planes(fa, torch.float64, dev), 8)
    fx = planes(rng.standard_normal((fplan.nnzb_x, 8, 8, 2)) @ [1, 1j],
                torch.float64, dev)
    check(fmult, fx, "FD shape", 1e-12)
    fd_ms = _burst_ms(lambda: fmult(fx))
    fd_plain_ms = _burst_ms(lambda: fmult.plain(fx))
    fd_kernel_ms = _kernel_ms(lambda: fmult(fx), "pairpanel_spmm_mma_kernel")
    fs = fmult.schedule
    print(f"phase 2 golden-class 'z': tiles of {sched.rows} x {sched.cols} "
          f"blocks ({sched.warps_m} x {sched.warps_n} warps, {sched.ntiles} "
          f"tiles), {sched.staged_bytes / 1e6:.1f} MB staged per multiply "
          f"(one pair at a time: {16 * 2 * 32 * 32 * plan.n_pairs / 1e6:.1f} "
          f"MB); K1 {ms:.4f} ms ({flops / ms / 1e9:.2f} TFlop/s, "
          f"{100 * bound_ms / ms:.1f}% of the bound), plain {plain_ms:.4f} "
          f"ms (CUDA events, 20 calls back to back)", flush=True)
    print(f"phase 2 FD rtb=12.75 'z' ({fplan.n_pairs} pairs, tiles of "
          f"{fs.rows} x {fs.cols}, {fs.ntiles} tiles): K1 {fd_kernel_ms:.4f} "
          f"ms of device time (torch.profiler); {fd_ms:.4f} ms a call "
          f"back to back (host dispatch), plain {fd_plain_ms:.4f} ms",
          flush=True)
    print(f"phase 2 golden-class 'z' library call (complex128 BSR "
          f"torch.sparse.mm): "
          + (f"{library_ms:.4f} ms" if lib else f"refused: {why}")
          + f"; K1 bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_refused=why, staged_mb=sched.staged_bytes / 1e6,
                tile=f"{sched.rows} x {sched.cols}", fd_ms=fd_ms,
                fd_kernel_ms=fd_kernel_ms, fd_plain_ms=fd_plain_ms)


def phase_fd(dev, fd):
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    a, b = fd.a_with_data(), fd.b_with_data()
    ref = fd.x_reference.astype(np.float64)
    runs = []
    for _ in range(2):
        PairPlanMultiply.launches = 0
        t0 = time.perf_counter()
        xs, info = tt.bsrsv_z(a, fd.x, b, tolerance=1e-9, max_iterations=2000,
                              device=dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = PairPlanMultiply.launches
        maxdev = float(np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref)))
        require(info.return_status == 0,
                f"FD solve status {info.return_status} after "
                f"{info.iterations_needed} iterations, residuum "
                f"{info.residuum_reached:.3e}")
        require(maxdev < 1e-5, f"FD maxdev {maxdev:.3e} >= 1e-5")
        require(launches == 2 * info.iterations_needed + info.n_probes,
                f"{launches} kernel launches for {info.iterations_needed} "
                f"iterations and {info.n_probes} probes")
        runs.append((info, wall_ms, maxdev, launches))
    require(runs[0][0].iterations_needed == runs[1][0].iterations_needed,
            "the two FD solves took different iteration counts")
    info, wall_ms, maxdev, launches = runs[0]
    print(f"phase 3 FD rtb=12.75 bsrsv_z: {info.iterations_needed} iterations, "
          f"{info.n_probes} probes, residuum {info.residuum_reached:.3e}, "
          f"maxdev {maxdev:.3e}, wall {wall_ms:.1f} ms (second run "
          f"{runs[1][1]:.1f} ms), kernel launches {launches}", flush=True)
    return launches, info.iterations_needed, xs.data


def golden_z_problem(mb: int = 281, ncols: int = 16, deg: int = 11,
                     lm: int = 32):
    """The golden-class 'z' system of phases 4 and 15: seeded random
    complex128 blocks, A diagonally dominant."""
    rng = np.random.default_rng(281)
    a, x, b = golden_class_patterns(mb, deg, ncols)
    a = a.with_data(dominant_fill(rng, a.nnzb, deg, lm))
    b = b.with_data(rng.standard_normal((b.nnzb, lm, lm, 2)) @ [1, 1j])
    return a, x, b


def phase_golden(dev, timed_iterations: int = 20):
    from tfqmrgpu_tpu_torch import Solver

    a, x, b = golden_z_problem()
    s = Solver(a, x, b, precision="z", engine="auto", device=dev)
    require(s.engine == "pairs", f"auto picked {s.engine}")
    t0 = time.perf_counter()
    info = s.solve(tolerance=1e-10, max_iterations=500)
    wall_ms = (time.perf_counter() - t0) * 1e3
    require(info.return_status == 0, f"golden solve status {info.return_status}")
    x_solved = s.get_matrix("X")
    res = pattern_residual(s.plan, x_solved, a, b, dev)
    require(res < 1e-8, f"golden |AX-B|/|B| = {res:.3e}")
    # a fixed number of iterations (tolerance 0 never converges; one probe
    # at the cap) times the iteration itself rather than a short solve
    t0 = time.perf_counter()
    timed = s.solve(tolerance=0.0, max_iterations=timed_iterations)
    per_it = (time.perf_counter() - t0) * 1e3 / timed_iterations
    require(timed.return_status == 9 and timed.n_probes == 1,
            f"timed run status {timed.return_status}, {timed.n_probes} probes")
    print(f"phase 4 golden-class Solver(engine='auto'): {info.iterations_needed} "
          f"iterations, {info.n_probes} probes, |AX-B|/|B| {res:.3e}, wall "
          f"{wall_ms:.1f} ms; {per_it:.3f} ms per iteration over "
          f"{timed_iterations} iterations", flush=True)
    return info.iterations_needed, x_solved


def _rowtile_multiply(plan, lm, ln, av, xv, dev, r_tile=None, slots=None,
                      precision="highest"):
    """RowTileMultiply on ``dev`` over the plan's pack (the solver's choice,
    or ``r_tile``; its work list dealt to ``slots`` CTAs, by default those
    the card holds at once) in ``precision``, and the X panel of ``xv``."""
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import (
        RowTileMultiply, build_a_panels_device, choose_row_tile,
        pack_row_tiles)

    xp, lay = x_panel(plan, lm, ln, xv, torch.float32, dev)
    pack = (choose_row_tile(plan, lm) if r_tile is None else
            pack_row_tiles(plan.rowptr_a, plan.colind_a, plan.nrows, lm,
                           r_tile))
    a_re, a_im = planes(av, torch.float32, dev)
    mult = RowTileMultiply(pack, build_a_panels_device(pack, a_re),
                           build_a_panels_device(pack, a_im), lay.mask, ln,
                           slots=slots, precision=precision)
    return mult, xp, pack


# The shapes the staged design of K2 and K3 adds, as (LM, LN, block columns
# or group size, r_tile): wide planes whose lanes are no multiple of 4
# (c = 81, 65, 70: the 4-byte X copies), and 1, 2, 4 and 8 tiles side by
# side in a 64-row unit.
STAGED_SHAPES = ((8, 9, 9, 1), (4, 5, 13, 2), (8, 10, 7, 4), (32, 32, 2, 2),
                 (32, 32, 2, 1), (16, 16, 4, 1), (8, 8, 8, 1))


def _as_tuple(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary, which rules out the kernels' 16-byte X copies."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_staged(make, what: str, gate: float = 1e-4) -> float:
    """K2 or K3 at one shape, ``make(slots)`` giving (multiply, x): against
    its plain version, the same bits on a repeated launch, from an x that
    is not 16-byte aligned (the 4-byte copy branch), and from work lists
    dealt to 1 CTA, to 7, and to half as many CTAs as there are units (a
    unit count that is and is not a multiple of the slots).  Returns the
    maxdev."""
    mult, x = make(None)
    got = _as_tuple(mult(x))
    rel, _ = _maxdev(got, _as_tuple(mult.plain(x)))
    require(rel <= gate, f"{what} maxdev {rel:.3e} > {gate}")
    u = mult.units
    units = u.ngroups * u.row_blocks * -(-mult.launch_tables.c
                                         // mult.launch_tables.bn)
    runs = [("repeated", mult, x),
            ("misaligned x", mult, tuple(_misaligned(v) for v in x)
             if isinstance(x, tuple) else _misaligned(x))]
    runs += [(f"{n} slots", *make(n)) for n in (1, 7, max(units // 2, 1))]
    for label, m, xs in runs:
        again = _as_tuple(m(xs))
        torch.cuda.synchronize()
        require(all(torch.equal(p, q) for p, q in zip(got, again)),
                f"{what}: {label} differs in bits")
    return rel


def phase_rowtile(dev):
    from tfqmrgpu_tpu_torch import ALLOWED_BLOCK_SIZES, create_plan

    gate = 1e-4
    rng = np.random.default_rng(2025)
    worst = 0.0
    for lm, ln in ALLOWED_BLOCK_SIZES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=5)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for r_tile in (1, 4):
            mult, xp, _ = _rowtile_multiply(plan, lm, ln, av, xv, dev, r_tile)
            got = mult(xp)
            rel, _ = _maxdev(got, mult.plain(xp))
            again = mult(xp)
            torch.cuda.synchronize()
            require(rel <= gate, f"K3 ({lm},{ln}) r_tile {r_tile} maxdev "
                    f"{rel:.3e} > {gate}")
            require(all(torch.equal(p, q) for p, q in zip(got, again)),
                    f"K3 ({lm},{ln}) r_tile {r_tile}: repeated launch differs")
            worst = max(worst, rel)

    side = set()
    for lm, ln, ncols, r_tile in STAGED_SHAPES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=ncols)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]

        def make(slots):
            return _rowtile_multiply(plan, lm, ln, av, xv, dev, r_tile,
                                     slots)[:2]

        worst = max(worst, check_staged(
            make, f"K3 ({lm},{ln}) x {ncols} columns, r_tile {r_tile}"))
        side.add(make(None)[0].units.nt)
    require(side >= {1, 2, 4, 8}, f"K3 tiles side by side: {sorted(side)}")

    plan = create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    mult, xp, pack = _rowtile_multiply(plan, 32, 32, av, xv, dev)
    got = mult(xp)
    rel, abs_err = _maxdev(got, mult.plain(xp))
    again = mult(xp)
    torch.cuda.synchronize()
    require(rel <= gate, f"K3 golden maxdev {rel:.3e} > {gate}")
    require(all(torch.equal(p, q) for p, q in zip(got, again)),
            "K3 golden: repeated launch differs")
    print(f"phase 5 K3 vs plain: 15 block sizes x r_tile (1, 4) and "
          f"{len(STAGED_SHAPES)} added shapes (c = 81, 65, 70 by 4-byte copies; 1, 2, "
          f"4, 8 tiles a unit; misaligned x; work lists for 1, 7 and "
          f"units/2 CTAs: the same bits), worst maxdev {worst:.3e}; "
          f"golden-class (r_tile {pack.r_tile}, ku {pack.ku}, {pack.ntiles} "
          f"tiles) {rel:.3e}; repeated launches bit-identical", flush=True)
    ms, plain_ms = _time_ms(lambda: mult(xp)), _time_ms(lambda: mult.plain(xp))
    kernel_ms = _kernel_ms(lambda: mult(xp), "rowtile_spmm_kernel")
    burst_ms = _burst_ms(lambda: mult(xp))
    lib, why = library_product(plan, av, xp, torch.complex64, mult.plain(xp),
                               gate)
    library_ms = _time_ms(lib) if lib else None
    nr, c = plan.nrows * 32, plan.ncols * 32
    # the work this plan needs: every A block once against all c columns
    flops = plan.nnzb_a * 8.0 * 32 * 32 * c
    bound_ms, bound_by = bound(
        8 * (plan.nnzb_a * 32 * 32 + 2 * nr * c)
        + 4 * pack.xcols.size + plan.nrows * plan.ncols, flops)
    print(f"phase 5 timing ('c', golden-class): K3 {kernel_ms:.4f} ms of "
          f"device time ({flops / kernel_ms / 1e9:.2f} TFlop/s, "
          f"{100 * bound_ms / kernel_ms:.1f}% of the bound), {burst_ms:.4f} "
          f"ms a call back to back, {ms:.4f} ms median of 20 single calls; "
          f"plain {plain_ms:.4f} ms, library (complex64 BSR "
          f"torch.sparse.mm) "
          + (f"{library_ms:.4f} ms" if lib else f"refused: {why}")
          + f"; bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=abs_err, ms=ms, kernel_ms=kernel_ms,
                burst_ms=burst_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                library_refused=why)


def phase_golden_c(dev, timed_iterations: int = 10):
    from tfqmrgpu_tpu_torch import Solver
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

    a, x, b = golden_c_problem()
    s = Solver(a, x, b, precision="c", engine="auto", device=dev)
    require(s.engine == "pallas", f"auto picked {s.engine}")
    require((s._pack.r_tile, s._pack.ku) == (2, 12),
            f"pack r_tile {s._pack.r_tile}, ku {s._pack.ku}")
    RowTileMultiply.launches = 0
    t0 = time.perf_counter()
    info = s.solve(tolerance=1e-5, max_iterations=500)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = RowTileMultiply.launches
    require(info.return_status == 0,
            f"golden 'c' solve status {info.return_status}")
    require(launches == 2 * info.iterations_needed + info.n_probes,
            f"{launches} K3 launches for {info.iterations_needed} iterations "
            f"and {info.n_probes} probes")
    res = pattern_residual(s.plan, s.get_matrix("X"), a, b, dev)
    require(res < 1e-4, f"golden 'c' |AX-B|/|B| = {res:.3e}")
    # a fixed number of iterations, as in phase 4; in float32 every column
    # of this well-conditioned system stops by itself (the reference's
    # breakdown flags) after 12 iterations, so 10 are timed
    t0 = time.perf_counter()
    timed = s.solve(tolerance=0.0, max_iterations=timed_iterations)
    torch.cuda.synchronize()
    per_it = (time.perf_counter() - t0) * 1e3 / timed_iterations
    require(timed.return_status == 9 and timed.n_probes == 1,
            f"timed run status {timed.return_status}, {timed.n_probes} probes")
    print(f"phase 6 golden-class 'c' Solver(engine='auto') -> {s.engine} "
          f"(r_tile {s._pack.r_tile}, ku {s._pack.ku}): "
          f"{info.iterations_needed} iterations, {info.n_probes} probes, "
          f"|AX-B|/|B| {res:.3e}, K3 launches {launches}, wall "
          f"{wall_ms:.1f} ms; {per_it:.3f} ms per iteration over "
          f"{timed_iterations} iterations", flush=True)
    return launches, info.iterations_needed, per_it


def phase_dense(dev):
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    fd = generate_fd_problem(rtb=6.75, reference=True)
    ref = fd.x_reference.astype(np.float64)
    t0 = time.perf_counter()
    xs, info = tt.bsrsv_z(fd.a_with_data(), fd.x, fd.b_with_data(),
                          tolerance=1e-9, max_iterations=2000, device=dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    maxdev = float(np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref)))
    require(info.engine == "dense", f"auto picked {info.engine}")
    require(info.return_status == 0,
            f"FD rtb=6.75 status {info.return_status}")
    require(maxdev < 1e-5, f"FD rtb=6.75 maxdev {maxdev:.3e} >= 1e-5")
    print(f"phase 7 FD rtb=6.75 bsrsv_z -> {info.engine}: "
          f"{info.iterations_needed} iterations, {info.n_probes} probes, "
          f"residuum {info.residuum_reached:.3e}, maxdev {maxdev:.3e}, wall "
          f"{wall_ms:.1f} ms (set-up included)", flush=True)
    return info.iterations_needed


def phase_probe(dev):
    from tfqmrgpu_tpu_torch import dma_probe

    dma_probe.StreamProbe.launches = 0
    res = dma_probe.sweep(dev)
    launches = dma_probe.StreamProbe.launches
    require(launches > 0, "the probe sweep launched no kernel")
    for r in res["variants"]:
        print(f"phase 8 K4 stage {r['stage_kb']:3d} KiB n_ops {r['n_ops']}: "
              f"{r['gbps']:.1f} GB/s ({100 * r['share']:.1f}% of 3.35 TB/s), "
              f"{r['ms']:.4f} ms, maxdev {r['maxdev']:.2e}", flush=True)
    for y in res["yardsticks"]:
        print(f"phase 8 n_ops {y['n_ops']}: copy_ {y['copy_gbps']:.1f} GB/s "
              f"read+write ({100 * y['copy_share']:.1f}%), plain "
              f"{y['plain_ms']:.4f} ms", flush=True)
    best = max(res["variants"], key=lambda r: r["gbps"])
    yard = next(y for y in res["yardsticks"] if y["n_ops"] == best["n_ops"])
    rows, cols = dma_probe.ROWS, dma_probe.COLS
    adds = best["bytes"] / 4 / cols * dma_probe.SLICE
    bound_ms, bound_by = bound(best["bytes"] + rows * dma_probe.SLICE * 4,
                               adds)
    return dict(launches=launches, max_abs_err=best["max_abs_err"],
                ms=best["ms"], plain_ms=yard["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=yard["copy_ms"],
                variant=f"stage {best['stage_kb']} KiB, n_ops {best['n_ops']}",
                gbps=best["gbps"], copy_gbps=yard["copy_gbps"])


def phase_packed(dev, fd):
    from tfqmrgpu_tpu_torch import ALLOWED_BLOCK_SIZES, create_plan
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply
    from tfqmrgpu_tpu_torch.solver import choose_group_size

    gate = 1e-4

    def check(mult, x, what):
        got = mult(x)
        rel, abs_err = _maxdev((got,), (mult.plain(x),))
        again = mult(x)
        torch.cuda.synchronize()
        require(rel <= gate, f"K2 {what} maxdev {rel:.3e} > {gate}")
        require(torch.equal(got, again), f"K2 {what}: repeated launch differs")
        return rel, abs_err

    rng = np.random.default_rng(2026)
    worst = 0.0
    for lm, ln in ALLOWED_BLOCK_SIZES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=5)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for group in (1, 2):
            for r_tile in (1, 2):
                mult, xf, _ = packed_multiply(plan, lm, ln, av, xv, dev,
                                              group, r_tile)
                rel, _ = check(mult, xf, f"({lm},{ln}) G {group} r_tile "
                               f"{r_tile}")
                worst = max(worst, rel)
    for lm, ln, group in ((32, 64, 8), (4, 32, 16)):     # 512-lane planes
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=group)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        mult, xf, _ = packed_multiply(plan, lm, ln, av, xv, dev, group)
        worst = max(worst, check(mult, xf, f"({lm},{ln}) G {group}")[0])
    side = set()
    for lm, ln, group, r_tile in STAGED_SHAPES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=group)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]

        def make(slots):
            return packed_multiply(plan, lm, ln, av, xv, dev, group, r_tile,
                                   slots)[:2]

        worst = max(worst, check_staged(
            make, f"K2 ({lm},{ln}) G {group} r_tile {r_tile}"))
        side.add(make(None)[0].units.nt)
    require(side >= {1, 2, 4, 8}, f"K2 tiles side by side: {sorted(side)}")
    fplan = create_plan(fd.a, fd.x, fd.b, device=dev)
    fx = rng.standard_normal((fplan.nnzb_x, 8, 8, 2)) @ [1, 1j]
    fmult, fxf, fpack = packed_multiply(fplan, 8, 8, fd.a_with_data().data,
                                        fx, dev)
    frel, _ = check(fmult, fxf, "FD rtb=12.75")
    fd_ms, fd_plain_ms = (_time_ms(lambda: fmult(fxf)),
                          _time_ms(lambda: fmult.plain(fxf)))
    fd_kernel_ms = _kernel_ms(lambda: fmult(fxf), "pairpanel_tiles_kernel")
    print(f"phase 9 K2 vs plain: 15 block sizes x G (1, 2) x r_tile (1, 2), "
          f"512 lanes at (32, 64) G 8 and (4, 32) G 16, and {len(STAGED_SHAPES)} "
          f"added shapes (c = 81, 65, 70 by 4-byte copies; 1, 2, 4, 8 tiles a "
          f"unit; misaligned x; work lists for 1, 7 and units/2 CTAs: the "
          f"same bits), worst maxdev {worst:.3e}; FD rtb=12.75 fine pack "
          f"({fpack.ntiles} tiles, ku {fpack.ku}, {2 * fpack.ln} lanes, "
          f"{fmult.units.nt} tiles a unit) {frel:.3e}, K2 {fd_kernel_ms:.4f} "
          f"ms of device time, {fd_ms:.4f} ms a single call, plain "
          f"{fd_plain_ms:.4f} ms; repeated launches bit-identical",
          flush=True)

    plan = create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    pair_y = np.repeat(np.arange(plan.nnzb_x),
                       np.diff(plan.starts.cpu().numpy()))
    picked = choose_group_size(
        plan.pairs.cpu().numpy().astype(np.int64), pair_y, plan.nnzb_x, 32,
        32, np.repeat(np.arange(plan.nrows), np.diff(plan.rowptr_x)),
        plan.colindx.cpu().numpy().astype(np.int64), plan.ncols)
    flops = plan.n_pairs * 8.0 * 32 ** 3          # the products needed
    sweep = {}
    for group in (1, 2, 4, 8):
        mult, xf, pplan = packed_multiply(plan, 32, 32, av, xv, dev, group)
        rel, abs_err = check(mult, xf, f"golden G {group}")
        ms = _time_ms(lambda: mult(xf))
        kernel_ms = _kernel_ms(lambda: mult(xf), "pairpanel_tiles_kernel")
        burst_ms = _burst_ms(lambda: mult(xf))
        plain_ms = _time_ms(lambda: mult.plain(xf))
        nbytes = 4 * (mult.a_panels.numel() + 2 * xf.numel()
                      + mult.xloc.numel())
        bound_ms, bound_by = bound(nbytes, flops)
        sweep[group] = dict(max_abs_err=abs_err, rel=rel, ms=ms,
                            kernel_ms=kernel_ms, burst_ms=burst_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, ntiles=pplan.ntiles,
                            ku=pplan.ku, mbytes=nbytes / 1e6)
        print(f"phase 9 golden-class K2 G {group} ({pplan.ntiles} tiles, ku "
              f"{pplan.ku}, {2 * pplan.ln} lanes, {nbytes / 1e6:.1f} MB, "
              f"{mult.units.nt} tiles a unit): {kernel_ms:.4f} ms of device "
              f"time ({flops / kernel_ms / 1e9:.2f} TFlop/s, "
              f"{100 * bound_ms / kernel_ms:.1f}% of the bound), "
              f"{burst_ms:.4f} ms a call back to back, {ms:.4f} ms median of "
              f"20 single calls; plain {plain_ms:.4f} ms, maxdev {rel:.3e}; "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        del mult, xf
    fastest = min(sweep, key=lambda g: sweep[g]["ms"])
    k1 = PairPlanMultiply(plan, *planes(av, torch.float32, dev), 32)
    xp = planes(xv, torch.float32, dev)
    k1_c_ms = _time_ms(lambda: k1(xp))
    xpan, lay = x_panel(plan, 32, 32, xv, torch.float32, dev)
    want = tuple(torch.from_numpy(lay.pack_x(y.cpu().numpy())).to(dev)
                 for y in k1.plain(xp))
    lib, why = library_product(plan, av, xpan, torch.complex64, want, gate)
    library_ms = _time_ms(lib) if lib else None
    print(f"phase 9 golden-class 'c': the rule picks G {picked}, the fastest "
          f"K2 is G {fastest} ({sweep[fastest]['ms']:.4f} ms); K1 in 'c' on "
          f"the plain pair table {k1_c_ms:.4f} ms; library (complex64 BSR "
          f"torch.sparse.mm) "
          + (f"{library_ms:.4f} ms" if lib else f"refused: {why}"), flush=True)
    row = sweep[picked]
    return dict(max_abs_err=row["max_abs_err"], ms=row["ms"],
                kernel_ms=row["kernel_ms"], burst_ms=row["burst_ms"],
                fd_kernel_ms=fd_kernel_ms,
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=library_ms,
                library_refused=why, group=picked, fastest_group=fastest,
                ms_by_group={g: sweep[g]["ms"] for g in sweep},
                k1_c_ms=k1_c_ms, fd_ms=fd_ms, fd_plain_ms=fd_plain_ms)


def phase_golden_pairs_c(dev, timed_iterations: int = 10):
    from tfqmrgpu_tpu_torch import Solver
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPanelMultiply

    a, x, b = golden_c_problem()
    s = Solver(a, x, b, precision="c", engine="pairs", device=dev)
    require(s._pp_plan is not None and s._gp is not None
            and s._gp.group_size == 8,
            f"packed plan {s._pp_plan is not None}, groups {s._gp}")
    PairPanelMultiply.launches = 0
    t0 = time.perf_counter()
    info = s.solve(tolerance=1e-5, max_iterations=500)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = PairPanelMultiply.launches
    require(info.return_status == 0,
            f"golden 'c' pairs solve status {info.return_status}")
    require(launches == 2 * info.iterations_needed + info.n_probes,
            f"{launches} K2 launches for {info.iterations_needed} iterations "
            f"and {info.n_probes} probes")
    x_solved = s.get_matrix("X")
    res = pattern_residual(s.plan, x_solved, a, b, dev)
    require(res < 1e-4, f"golden 'c' pairs |AX-B|/|B| = {res:.3e}")
    # 10 fixed iterations, as in phase 6
    t0 = time.perf_counter()
    timed = s.solve(tolerance=0.0, max_iterations=timed_iterations)
    torch.cuda.synchronize()
    per_it = (time.perf_counter() - t0) * 1e3 / timed_iterations
    require(timed.return_status == 9 and timed.n_probes == 1,
            f"timed run status {timed.return_status}, {timed.n_probes} probes")
    pp = s._pp_plan
    print(f"phase 10 golden-class 'c' Solver(engine='pairs'): G "
          f"{s._gp.group_size}, {pp.ntiles} tiles, ku {pp.ku}; "
          f"{info.iterations_needed} iterations, {info.n_probes} probes, "
          f"|AX-B|/|B| {res:.3e}, K2 launches {launches}, wall {wall_ms:.1f} "
          f"ms; {per_it:.3f} ms per iteration over {timed_iterations} "
          f"iterations", flush=True)
    return launches, x_solved, info.iterations_needed, info.n_probes, per_it


def phase_fd_c(dev, fd):
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPanelMultiply

    # the engine and the pack 'auto' gives this pattern in 'c': the fine
    # pack at G 1 (one column), or the superblock where the card's rates
    # (ops/rates.py) say merging pays
    probe = tt.Solver(fd.a, fd.x, fd.b, precision="c", lm=8, ln=8,
                      device=dev)
    sup = probe._sup
    require(probe.engine == "pairs" and probe._pp_plan is not None
            and (probe._gp is None if sup is None else
                 sup.f_row in (2, 4) and sup.lm2 == 8 * sup.f_row
                 and probe._pp_plan.lm == sup.lm2 and sup.ln == 8),
            f"FD 'c': auto picked {probe.engine}, groups {probe._gp}, "
            f"superblock {sup}")
    pack = (f"G 1, {probe._pp_plan.ntiles} tiles, ku {probe._pp_plan.ku}"
            if sup is None else
            f"superblock f {sup.f_row}, LM' {sup.lm2}, LN {sup.ln}, "
            f"{sup.n_cells} cells, MAC inflation {sup.mac_inflation:.2f}x, "
            f"{probe._pp_plan.ntiles} tiles, ku {probe._pp_plan.ku}")
    ref = fd.x_reference.astype(np.complex128)
    PairPanelMultiply.launches = 0
    t0 = time.perf_counter()
    xs, info = tt.bsrsv_c(fd.a_with_data(), fd.x, fd.b_with_data(),
                          tolerance=1e-5, max_iterations=2000, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = PairPanelMultiply.launches
    require(info.engine == "pairs", f"bsrsv_c took {info.engine}")
    # a breakdown stops early and reports max_iterations; every other end
    # counts the iterations it ran
    want = 2 * info.iterations_needed + info.n_probes
    require(0 < launches <= want if info.return_status == 2
            else launches == want,
            f"{launches} K2 launches for {info.iterations_needed} iterations "
            f"and {info.n_probes} probes (status {info.return_status})")
    require(bool(np.isfinite(xs.data).all()), "FD 'c' X is not finite")
    maxdev = float(np.max(np.abs(xs.data - ref)) / np.max(np.abs(ref)))
    print(f"phase 11 FD rtb=12.75 bsrsv_c -> {info.engine} ({pack}): status "
          f"{info.return_status}, {info.iterations_needed} iterations, "
          f"{info.n_probes} probes, residuum {info.residuum_reached:.3e}, "
          f"maxdev {maxdev:.3e}, K2 launches {launches}, wall {wall_ms:.1f} "
          f"ms (set-up included)", flush=True)
    return pack


# the JAX package's 'm' on FD rtb=12.75 on a CPU, for comparison
# (python3 tools/jax_mixed_counts.py 12.75): c-iterations, refinement
# iterations, correction rounds
JAX_FD_M_COUNTS = (500, 125, 3)


def residual_checks(rounds: int, max_rounds: int = 12) -> int:
    """The float64 residuals ``refinement_loop`` measured: one before each
    correction round and one more at the stop, unless the rounds ran out."""
    return min(rounds + 1, max_rounds)


def fallback_k1(info) -> int:
    """K1 launches of the 'z' fallback of an 'm' solve on the 'pairs'
    engine: 2 an iteration, 1 a probe, 1 for B - A X0."""
    r = info.refinement
    if not r["fallback"]:
        return 0
    return 2 * (info.iterations_needed - r["iterations"]) + info.n_probes + 1


def phase_file_fd(dev, fd, z_iterations: int, pack: str):
    """Phase 12: FD rtb=12.75 through the problem file and the parity CLI,
    in 'z' (K1) and in 'm' (K2 for the c stage and the corrections, K1 for
    the float64 residuals); ``pack`` is phase 11's 'c' pack, which the c
    stage takes."""
    from tfqmrgpu_tpu_torch import bench
    from tfqmrgpu_tpu_torch.io.xmlio import read_xml, write_xml
    from tfqmrgpu_tpu_torch.ops.pairpanel import (PairPanelMultiply,
                                                  PairPlanMultiply)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "FD_example.xml")
        t0 = time.perf_counter()
        write_xml(fd, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        read_xml(path)
        read_s = time.perf_counter() - t0
        mbytes = os.path.getsize(path) / 1e6
        PairPlanMultiply.launches = 0
        z = bench.run_tfqmr(path, "z", max_iterations=2000, echo=0,
                            device=dev)
        k1_z = PairPlanMultiply.launches
        zi = z.info
        require(z.rc == 0 and z.maxdev < 1e-5,
                f"file FD 'z': rc {z.rc}, maxdev {z.maxdev}")
        require(zi.return_status == 0 and zi.engine == "pairs",
                f"file FD 'z': status {zi.return_status} on {zi.engine}")
        require(k1_z == 2 * zi.iterations_needed + zi.n_probes,
                f"file FD 'z': {k1_z} K1 launches for {zi.iterations_needed} "
                f"iterations and {zi.n_probes} probes")
        PairPlanMultiply.launches = PairPanelMultiply.launches = 0
        m = bench.run_tfqmr(path, "m", max_iterations=2000, echo=0,
                            device=dev)
        k1_m, k2_m = PairPlanMultiply.launches, PairPanelMultiply.launches
    mi, r = m.info, m.info.refinement
    require(m.rc == 0 and mi.return_status == 0
            and mi.residuum_reached <= 1e-9,
            f"file FD 'm': rc {m.rc}, status {mi.return_status}, residuum "
            f"{mi.residuum_reached:.3e}")
    require(r["c_engine"] == "pairs", f"file FD 'm' c stage on {r['c_engine']}")
    want_k1 = residual_checks(r["rounds"]) + fallback_k1(mi)
    require(k1_m == want_k1, f"file FD 'm': {k1_m} K1 launches, want {want_k1}")
    require(k2_m >= 2 * r["c_iterations"],
            f"file FD 'm': {k2_m} K2 launches for {r['c_iterations']} "
            "c-iterations")
    jc, jr, jrounds = JAX_FD_M_COUNTS
    print(f"phase 12 FD rtb=12.75 file ({mbytes:.2f} MB, write_xml "
          f"{write_s:.3f} s, read_xml {read_s:.3f} s): 'z' -> {zi.engine} "
          f"{zi.iterations_needed} iterations (phase 3: {z_iterations}), "
          f"maxdev {z.maxdev:.3e}, K1 launches {k1_z}, wall "
          f"{z.first_ms:.1f} ms", flush=True)
    print(f"phase 12 FD rtb=12.75 file 'm': c stage on {r['c_engine']} "
          f"(K2, {pack}) {r['c_iterations']} c-iterations (residuum "
          f"{r['c_residuum']:.3e}) + {r['iterations'] - r['c_iterations']} "
          f"refinement iterations over {r['rounds']} rounds, 'z' fallback "
          f"{'ran' if r['fallback'] else 'not needed'}, residuum "
          f"{mi.residuum_reached:.3e}, maxdev {m.maxdev:.3e}, K2 launches "
          f"{k2_m}, K1 launches {k1_m}, wall {m.first_ms:.1f} ms (set-up "
          f"included); the JAX package on a CPU: {jc} + {jr} over {jrounds} "
          f"rounds", flush=True)
    return k1_z, k1_m, k2_m, (r["c_iterations"],
                              r["iterations"] - r["c_iterations"])


def phase_golden_m(dev):
    """Phase 13: golden-class 'm' through bsrsv_m: the c stage on the row
    tiles (K3), the float64 residuals through K1."""
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

    a, x, b = golden_c_problem()
    a = a.with_data(a.data.astype(np.complex128))
    b = b.with_data(b.data.astype(np.complex128))
    PairPlanMultiply.launches = RowTileMultiply.launches = 0
    t0 = time.perf_counter()
    xs, info = tt.bsrsv_m(a, x, b, tolerance=1e-9, max_iterations=500,
                          device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    k1, k3 = PairPlanMultiply.launches, RowTileMultiply.launches
    r = info.refinement
    require(info.return_status == 0 and info.residuum_reached <= 1e-9,
            f"golden 'm' status {info.return_status}, residuum "
            f"{info.residuum_reached:.3e}")
    require(r["c_engine"] == "pallas", f"golden 'm' c stage on {r['c_engine']}")
    from tfqmrgpu_tpu_torch import create_plan

    res = pattern_residual(create_plan(a, x, b, device=dev), xs.data, a, b,
                           dev)
    require(res < 1e-8, f"golden 'm' |AX-B|/|B| = {res:.3e}")
    want_k1 = residual_checks(r["rounds"]) + fallback_k1(info)
    require(k1 == want_k1, f"golden 'm': {k1} K1 launches, want {want_k1}")
    require(k3 >= 2 * r["c_iterations"],
            f"golden 'm': {k3} K3 launches for {r['c_iterations']} "
            "c-iterations")
    print(f"phase 13 golden-class bsrsv_m: c stage on {r['c_engine']} "
          f"{r['c_iterations']} iterations (residuum {r['c_residuum']:.3e}) "
          f"+ {r['iterations'] - r['c_iterations']} over {r['rounds']} "
          f"rounds, 'z' fallback {'ran' if r['fallback'] else 'not needed'}, "
          f"residuum {info.residuum_reached:.3e}, |AX-B|/|B| {res:.3e}, K3 "
          f"launches {k3}, K1 launches {k1}, wall {wall_ms:.1f} ms (set-up "
          f"included)", flush=True)
    return k1, k3, (r["c_iterations"], r["iterations"], r["rounds"])


def phase_checkpoint(dev, fd, z_iterations: int):
    """Phase 14: FD rtb=12.75 'z' through solve_checkpointed in chunks of
    25 with a state file, interrupted after one chunk and resumed in a new
    Solver (K1)."""
    from tfqmrgpu_tpu_torch import Solver
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    a, b = fd.a_with_data(), fd.b_with_data()
    ref = fd.x_reference.astype(np.float64)
    PairPlanMultiply.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "fd_state.npz")
        t0 = time.perf_counter()
        first = Solver(a, fd.x, b, precision="z", device=dev)
        cut = first.solve_checkpointed(tolerance=1e-9, max_iterations=25,
                                       chunk=25, state_path=state)
        require(cut.return_status != 0 and os.path.exists(state),
                f"interrupted chunk: status {cut.return_status}, state "
                f"file {os.path.exists(state)}")
        second = Solver(a, fd.x, b, precision="z", device=dev)
        info = second.solve_checkpointed(tolerance=1e-9, max_iterations=2000,
                                         chunk=25, state_path=state)
        wall_ms = (time.perf_counter() - t0) * 1e3
        left = os.path.exists(state)
    launches = PairPlanMultiply.launches
    maxdev = float(np.max(np.abs(second.get_matrix("X") - ref))
                   / np.max(np.abs(ref)))
    require(info.return_status == 0, f"checkpointed FD status "
            f"{info.return_status} after {info.iterations_needed}")
    require(not left, "the state file was not removed")
    require(maxdev < 1e-5, f"checkpointed FD maxdev {maxdev:.3e} >= 1e-5")
    require(launches >= 2 * info.iterations_needed,
            f"{launches} K1 launches for {info.iterations_needed} iterations")
    print(f"phase 14 FD rtb=12.75 solve_checkpointed 'z' (chunks of 25, cut "
          f"after 25, resumed in a new Solver): {info.iterations_needed} "
          f"iterations in all (uninterrupted, phase 3: {z_iterations}), "
          f"maxdev {maxdev:.3e}, state file removed, K1 launches {launches}, "
          f"wall {wall_ms:.1f} ms (set-up included)", flush=True)
    return launches


def _walls_ms(fn, reps: int = 3) -> list:
    """Host walls (ms) of ``reps`` calls of ``fn``, each ending in a
    synchronize."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _c_walls_ms(fn, reps: int = 3) -> list:
    """The C calls' own host walls (ms) of ``reps`` calls of ``fn``, which
    returns them last."""
    return [fn()[-1] for _ in range(reps)]


def _timed(fn):
    """(fn(), host ms of the call, ending in a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _c_ok(lib, st: int, what: str):
    require(st == 0, f"{what}: status {st} "
            f"({lib.tfqmrgpuGetErrorString(st).decode()})")


def c_ten_steps(lib, a, x, b, threshold: float, max_iterations: int,
                precision: bytes = b"z"):
    """The reference's ten-step workflow through the port's C library by
    ctypes: createHandle, setStream, createPlan, bufferSize,
    createWorkspace, setBuffer, setMatrix('A', 'B'), solve, getInfo,
    getMatrix('X'), destroy*.  Returns (X complex, iterations, bufferSize,
    peak device bytes the workflow added, the plan's api state read before
    destroyPlan, {step: host ms}, host ms of all the C calls)."""
    import ctypes

    from tfqmrgpu_tpu_torch import api

    lm, ln = a.data.shape[1], b.data.shape[2]
    rpa, cia, rpx, cix, rpb, cib = (
        np.ascontiguousarray(v, np.int32)
        for v in (a.rowptr, a.colind, x.rowptr, x.colind, b.rowptr,
                  b.colind))
    amat, bmat = riri(a.data), riri(b.data)
    xmat = np.zeros((x.nnzb, lm, ln, 2))
    h, p = ctypes.c_int64(0), ctypes.c_int64(0)
    size, buf = ctypes.c_size_t(0), ctypes.c_void_p(0)
    resid, iters = ctypes.c_double(0), ctypes.c_int32(0)
    flops, flops_all = ctypes.c_double(0), ctypes.c_double(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clock = [time.perf_counter()]
    steps = {}

    def lap(step):
        clock.append(time.perf_counter())
        steps[step] = steps.get(step, 0.0) + (clock[-1] - clock[-2]) * 1e3

    _c_ok(lib, lib.tfqmrgpuCreateHandle(ctypes.byref(h)), "createHandle")
    _c_ok(lib, lib.tfqmrgpuSetStream(h, 0), "setStream")
    lap("handle")
    _c_ok(lib, lib.tfqmrgpu_bsrsv_createPlan(
        h, ctypes.byref(p), a.nrows, rpa.ctypes.data, a.nnzb,
        cia.ctypes.data, rpx.ctypes.data, x.nnzb, cix.ctypes.data,
        rpb.ctypes.data, b.nnzb, cib.ctypes.data, 0, 0), "createPlan")
    lap("createPlan")
    _c_ok(lib, lib.tfqmrgpu_bsrsv_bufferSize(
        h, p, lm, lm, ln, ln, precision, ctypes.byref(size)), "bufferSize")
    _c_ok(lib, lib.tfqmrgpuCreateWorkspace(ctypes.byref(buf), size.value,
                                           b"d"), "createWorkspace")
    _c_ok(lib, lib.tfqmrgpu_bsrsv_setBuffer(h, p, buf), "setBuffer")
    lap("setBuffer")
    for var, val, d2 in ((b"A", amat, lm), (b"B", bmat, ln)):
        _c_ok(lib, lib.tfqmrgpu_bsrsv_setMatrix(
            h, p, var, val.ctypes.data, precision, lm, d2, b"n", 0x55),
            f"setMatrix {var.decode()}")
    lap("setMatrix")
    _c_ok(lib, lib.tfqmrgpu_bsrsv_solve(h, p, threshold, max_iterations),
          "solve")
    torch.cuda.synchronize()
    lap("solve")
    peak = torch.cuda.max_memory_allocated() - base
    _c_ok(lib, lib.tfqmrgpu_bsrsv_getInfo(
        h, p, ctypes.byref(resid), ctypes.byref(iters), ctypes.byref(flops),
        ctypes.byref(flops_all)), "getInfo")
    _c_ok(lib, lib.tfqmrgpu_bsrsv_getMatrix(
        h, p, b"X", xmat.ctypes.data, precision, lm, ln, b"n", 0x55),
        "getMatrix")
    lap("getMatrix")
    state = api._PLANS[p.value]
    _c_ok(lib, lib.tfqmrgpu_bsrsv_destroyPlan(h, p), "destroyPlan")
    _c_ok(lib, lib.tfqmrgpuDestroyWorkspace(buf), "destroyWorkspace")
    _c_ok(lib, lib.tfqmrgpuDestroyHandle(h), "destroyHandle")
    lap("destroy")
    return (xmat[..., 0] + 1j * xmat[..., 1], iters.value, size.value, peak,
            state, steps, sum(steps.values()))


def phase_capi(dev, fd, card: str, fd_iterations: int, fd_probes: int):
    """Phase 15: the C API.  Builds libtfqmrgpu_tpu_torch.so and drives the
    solver through it by ctypes in this process (its C functions run the
    bridge in this interpreter): (a) FD rtb=12.75 'z' through the one-call
    tfqmrgpu_bsrsv_z (K1), (b) the golden-class 'z' system through the
    ten-step workflow (K1), (c) golden-class 'c' through tfqmrgpu_bsrsv_c
    (K3), (d) golden-class 'm' through tfqmrgpu_bsrsv_m (K3, float64
    residuals on K1); then (e) the C example, built with gcc and run as its
    own process.  Each step's C path is timed beside the direct Python path
    on the same problem (medians of 3 host walls, the checked call the
    first of them)."""
    import sys

    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch import Solver, create_plan, native
    from tfqmrgpu_tpu_torch.ops.pairpanel import (PairPanelMultiply,
                                                  PairPlanMultiply)
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

    t_phase = time.perf_counter()
    path, build_s = native.build()
    lib = native.load()
    print(f"phase 15 C API: {path.name} built in {build_s:.1f} s (g++, "
          f"-Wl,-Bsymbolic; walls below are medians of 3 host walls on "
          f"{card})", flush=True)
    counters = (PairPlanMultiply, RowTileMultiply, PairPanelMultiply)
    k2_launches = []

    def drive(fn):
        """Counts zeroed just before ``fn`` and read just after: (result,
        (K1, K3, K2) launches)."""
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        k2_launches.append(PairPanelMultiply.launches)
        return out, tuple(c.launches for c in counters)

    f32 = lambda v: float(np.float32(v))    # the C threshold is a float

    # (a) FD rtb=12.75 'z', one-call
    a, b = fd.a_with_data(), fd.b_with_data()
    ref = fd.x_reference.astype(np.float64)
    run_a = lambda: c_onecall(lib, "z", a, fd.x, b, 1e-9, 2000)
    (st, xc, iters, resid, ms0), (k1a, k3, k2) = drive(run_a)
    _c_ok(lib, st, "FD tfqmrgpu_bsrsv_z")
    maxdev = float(np.max(np.abs(xc - ref)) / np.max(np.abs(ref)))
    require(iters == fd_iterations, f"FD C one-call: {iters} iterations, "
            f"phase 3: {fd_iterations}")
    require((k1a, k3, k2) == (2 * iters + fd_probes, 0, 0),
            f"FD C one-call: K1, K3, K2 launches {(k1a, k3, k2)} for {iters} "
            f"iterations and {fd_probes} probes")
    require(maxdev < 1e-5, f"FD C one-call maxdev {maxdev:.3e} >= 1e-5")
    c_ms = statistics.median([ms0] + _c_walls_ms(run_a, 2))
    py_ms = statistics.median(_walls_ms(lambda: tt.bsrsv_z(
        a, fd.x, b, tolerance=f32(1e-9), max_iterations=2000, device=dev)))
    print(f"phase 15 (a) FD rtb=12.75 tfqmrgpu_bsrsv_z: status 0, {iters} "
          f"iterations (phase 3: {fd_iterations}), residual {resid:.3e}, "
          f"maxdev {maxdev:.3e}, K1 launches {k1a}; wall C {c_ms:.1f} ms, "
          f"Python bsrsv_z {py_ms:.1f} ms", flush=True)

    # (b) golden-class 'z', the ten steps
    a, x, b = golden_z_problem()
    run_b = lambda: c_ten_steps(lib, a, x, b, 1e-10, 500)
    first_b, (k1b, k3, k2) = drive(run_b)
    xc, iters, nbytes, peak, state, _, _ = first_b
    info_c = state.solver.get_info()
    require(state.solver.engine == "pairs",
            f"golden C ten-step engine {state.solver.engine}")
    require((k1b, k3, k2) == (2 * iters + info_c.n_probes, 0, 0),
            f"golden C ten-step: K1, K3, K2 launches {(k1b, k3, k2)} for "
            f"{iters} iterations and {info_c.n_probes} probes")

    def direct_b():
        """The same steps in Python: (Solver, SolveInfo, X, {step: ms})."""
        t = [time.perf_counter()]
        s = Solver(a, x, b, precision="z", engine="auto", device=dev,
                   v3=state.solver._v3)   # 'z' keeps v3 unpacked
        t.append(time.perf_counter())
        info = s.solve(tolerance=1e-10, max_iterations=500)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        xs = s.get_matrix("X")
        t.append(time.perf_counter())
        return s, info, xs, dict(zip(("Solver", "solve", "get_matrix"),
                                     np.diff(t) * 1e3))

    first_direct_b = direct_b()
    s, info, xs, _ = first_direct_b
    rel = float(np.max(np.abs(xc - xs)) / np.max(np.abs(xs)))
    require(info.return_status == 0 and info.iterations_needed == iters,
            f"golden Solver: status {info.return_status}, "
            f"{info.iterations_needed} iterations, C path {iters}")
    require(rel <= 1e-12, f"golden C ten-step X vs Solver: {rel:.3e} > 1e-12")
    c_runs = [first_b] + [run_b() for _ in range(2)]
    py_runs = [first_direct_b[-1]] + [direct_b()[-1] for _ in range(2)]
    c_ms = statistics.median(r[-1] for r in c_runs)
    py_ms = statistics.median(sum(r.values()) for r in py_runs)
    c_steps = {k: statistics.median(r[-2][k] for r in c_runs)
               for k in c_runs[0][-2]}
    py_steps = {k: statistics.median(r[k] for r in py_runs)
                for k in py_runs[0]}
    print(f"phase 15 (b) golden-class 'z' ten-step C workflow -> "
          f"{state.solver.engine}: {iters} iterations, X vs "
          f"Solver(engine='auto') {rel:.3e}, K1 launches {k1b}; bufferSize "
          f"{nbytes / 1e6:.2f} MB, max_memory_allocated over the workflow "
          f"{peak / 1e6:.2f} MB; wall C {c_ms:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in c_steps.items())
          + f"), Python Solver {py_ms:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in py_steps.items()) + ")",
          flush=True)

    # (c) golden-class 'c', one-call
    a, x, b = golden_c_problem()
    plan = create_plan(a, x, b, device=dev)
    run_c = lambda: c_onecall(lib, "c", a, x, b, 1e-5, 500)
    (st, xc, iters, resid, ms0), (k1, k3c, k2) = drive(run_c)
    _c_ok(lib, st, "golden tfqmrgpu_bsrsv_c")
    direct_c = lambda: tt.bsrsv_c(a, x, b, tolerance=f32(1e-5),
                                  max_iterations=500, device=dev)
    (_, info), py0 = _timed(direct_c)
    require(info.engine == "pallas" and info.iterations_needed == iters,
            f"golden 'c': Python path on {info.engine} in "
            f"{info.iterations_needed} iterations, C path {iters}")
    require((k1, k3c, k2) == (0, 2 * iters + info.n_probes, 0),
            f"golden C 'c': K1, K3, K2 launches {(k1, k3c, k2)} for {iters} "
            f"iterations and {info.n_probes} probes")
    res = pattern_residual(plan, xc, a, b, dev)
    require(res < 1e-4, f"golden C 'c' |AX-B|/|B| = {res:.3e}")
    c_ms = statistics.median([ms0] + _c_walls_ms(run_c, 2))
    py_ms = statistics.median([py0] + _walls_ms(direct_c, 2))
    print(f"phase 15 (c) golden-class tfqmrgpu_bsrsv_c -> {info.engine}: "
          f"{iters} iterations, residual {resid:.3e}, |AX-B|/|B| {res:.3e}, "
          f"K3 launches {k3c}; wall C {c_ms:.1f} ms, Python bsrsv_c "
          f"{py_ms:.1f} ms", flush=True)

    # (d) golden-class 'm', one-call
    a = a.with_data(a.data.astype(np.complex128))
    b = b.with_data(b.data.astype(np.complex128))
    run_d = lambda: c_onecall(lib, "m", a, x, b, 1e-9, 500)
    (st, xc, iters, resid, ms0), (k1d, k3d, k2) = drive(run_d)
    _c_ok(lib, st, "golden tfqmrgpu_bsrsv_m")
    direct_d = lambda: tt.bsrsv_m(a, x, b, tolerance=f32(1e-9),
                                  max_iterations=500, device=dev)
    (_, info), py0 = _timed(direct_d)
    r = info.refinement
    require(info.iterations_needed == iters and r["c_engine"] == "pallas",
            f"golden 'm': Python path {info.iterations_needed} iterations, "
            f"c stage on {r['c_engine']}; C path {iters}")
    want_k1 = residual_checks(r["rounds"]) + fallback_k1(info)
    require(k1d == want_k1 and k3d >= 2 * r["c_iterations"] and k2 == 0,
            f"golden C 'm': K1, K3, K2 launches {(k1d, k3d, k2)}, want K1 "
            f"{want_k1}, K3 >= {2 * r['c_iterations']}")
    res = pattern_residual(plan, xc, a, b, dev)
    require(res < 1e-8, f"golden C 'm' |AX-B|/|B| = {res:.3e}")
    c_ms = statistics.median([ms0] + _c_walls_ms(run_d, 2))
    py_ms = statistics.median([py0] + _walls_ms(direct_d, 2))
    print(f"phase 15 (d) golden-class tfqmrgpu_bsrsv_m: status 0, {iters} "
          f"iterations ({r['c_iterations']} in the c stage on K3, "
          f"{r['rounds']} rounds), residual {resid:.3e}, |AX-B|/|B| "
          f"{res:.3e}, K1 launches {k1d} (one a float64 residual), K3 "
          f"{k3d}; wall C {c_ms:.1f} ms, Python bsrsv_m {py_ms:.1f} ms",
          flush=True)

    # (e) the C example as its own process
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "c_example")
        cc = subprocess.run(
            ["gcc", "-std=c99", os.path.join(
                root, "tfqmrgpu_tpu_torch", "examples",
                "tfqmrgpu_c_example.c"), *native.link_flags(), "-o", exe],
            capture_output=True, text=True, timeout=120)
        require(cc.returncode == 0, f"gcc: {cc.stderr.strip()}")
        # the embedded interpreter gets this interpreter's path: the card
        # machine's torch may live in a virtual environment
        env = dict(os.environ, LD_LIBRARY_PATH=str(path.parent),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [os.path.abspath(p) for p in sys.path if p]))
        t0 = time.perf_counter()
        run = subprocess.run([exe], capture_output=True, text=True, env=env,
                             cwd=tmp, timeout=300)
        wall_s = time.perf_counter() - t0
    require(run.returncode == 0 and "tfqmrgpu_c_example: OK" in run.stdout,
            f"C example exit {run.returncode}: {run.stdout}{run.stderr}")
    print(f"phase 15 (e) C example (gcc, its own process and interpreter): "
          f"{run.stdout.strip().splitlines()[0]}; OK in {wall_s:.1f} s; "
          f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1": {"phase 15 FD z C one-call": k1a,
                   "phase 15 golden z C ten-step": k1b,
                   "phase 15 golden m C one-call (residuals)": k1d},
            "k3": {"phase 15 golden c C one-call": k3c,
                   "phase 15 golden m C one-call (c stage, corrections)":
                       k3d},
            "k2": {"phase 15 C paths (a)-(d)": sum(k2_launches)}}


def _sharded_calls(mesh, its: int, probes: int, gathers: int) -> str:
    """Check a sharded solve's collectives: one halo all_gather a multiply
    and ``gathers`` for the result; per iteration four column sums and two
    convergence reductions, per probe three, and one for |B|.  Returns
    them per iteration."""
    ag, ar = mesh.calls["all_gather"], mesh.calls["all_reduce"]
    require(ag == 2 * its + probes + gathers,
            f"{ag} all_gathers for {its} iterations and {probes} probes")
    require(ar == 6 * its + 3 * probes + 1,
            f"{ar} all_reduces for {its} iterations and {probes} probes")
    return (f"{ag / its:.2f} all_gather + {ar / its:.2f} all_reduce per "
            f"iteration")


def phase_sharded(dev, fd, fd_x, fd_iterations: int, fd_launches: int,
                  golden_c_iterations: int, dense_iterations: int,
                  golden_m: tuple):
    """Phase 16: the sharded layer (``tfqmrgpu_tpu_torch.parallel``) at
    world size 1 on NCCL: every halo all_gather and all_reduce goes through
    NCCL on the card, and each count is checked.  Returns the 1 x 1 mesh,
    whose process group phase 17 goes on with, and the launches."""
    import torch.distributed as dist

    from tfqmrgpu_tpu_torch import create_plan
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply
    from tfqmrgpu_tpu_torch.parallel import (ShardedPanelSolver, make_mesh,
                                             multihost, partition_plan,
                                             sharded_solve, solve_sharded)

    t_phase = time.perf_counter()
    multihost.initialize(device=dev)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"process group {dist.get_backend()} of "
            f"{dist.get_world_size()} ranks")
    mesh = make_mesh(1, 1, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # (a) FD rtb=12.75 'z' through sharded_solve: K1 per shard
    a, b = fd.a_with_data(), fd.b_with_data()
    plan = create_plan(a, fd.x, b, device=dev)
    plan.lm, plan.ln = a.slow_block_dim, b.fast_block_dim
    part = partition_plan(plan, 1, 1)
    mesh.calls.clear()
    PairPlanMultiply.launches = 0
    (xr, xi, info), wall_a = timed(lambda: sharded_solve(
        plan, part, mesh, a.data.real, a.data.imag, b.data.real,
        b.data.imag, tolerance=1e-9, max_iterations=2000))
    k1_a = PairPlanMultiply.launches
    its, probes = info["iterations"], info["n_probes"]
    xdev = float(np.max(np.abs(xr + 1j * xi - fd_x)))
    ref = fd.x_reference.astype(np.float64)
    maxdev = float(np.max(np.abs(xr + 1j * xi - ref)) / np.max(np.abs(ref)))
    require(info["return_status"] == 0, f"sharded FD status "
            f"{info['return_status']}")
    require(its == fd_iterations and k1_a == fd_launches,
            f"sharded FD: {its} iterations, {k1_a} K1 launches; phase 3: "
            f"{fd_iterations}, {fd_launches}")
    require(xdev <= 1e-10, f"sharded FD X {xdev:.3e} from phase 3's")
    require(maxdev < 1e-5, f"sharded FD maxdev {maxdev:.3e} >= 1e-5")
    calls_a = _sharded_calls(mesh, its, probes, 2)
    print(f"phase 16 (a) FD rtb=12.75 'z' sharded_solve (1 x 1 on NCCL): "
          f"{its} iterations, {probes} probes (phase 3: {fd_iterations}), K1 "
          f"launches {k1_a}, X {xdev:.1e} from phase 3's, maxdev "
          f"{maxdev:.3e}, wall {wall_a:.1f} ms (set-up included), {calls_a}",
          flush=True)

    # (b) golden-class 'c' through solve_sharded(engine='auto'): K3
    a, x, b = golden_c_problem()
    mesh.calls.clear()
    RowTileMultiply.launches = 0
    (xs, info), wall_b = timed(lambda: solve_sharded(
        a, x, b, mesh=mesh, engine="auto", tolerance=1e-5,
        max_iterations=500))
    k3_b = RowTileMultiply.launches
    its, probes = info["iterations"], info["n_probes"]
    require(info["engine"] == "rowtile" and info["return_status"] == 0,
            f"sharded golden 'c': {info['engine']}, status "
            f"{info['return_status']}")
    require(abs(its - golden_c_iterations) <= 1,
            f"sharded golden 'c' {its} iterations, phase 6 "
            f"{golden_c_iterations}")
    require(k3_b == 2 * its + probes > 0,
            f"{k3_b} K3 launches for {its} iterations, {probes} probes")
    res_b = pattern_residual(create_plan(a, x, b, device=dev), xs, a, b, dev)
    require(res_b < 1e-4, f"sharded golden 'c' |AX-B|/|B| = {res_b:.3e}")
    calls_b = _sharded_calls(mesh, its, probes, 1)
    print(f"phase 16 (b) golden-class 'c' solve_sharded -> {info['engine']}: "
          f"{its} iterations, {probes} probes (phase 6: "
          f"{golden_c_iterations}), K3 launches {k3_b}, |AX-B|/|B| "
          f"{res_b:.3e}, wall {wall_b:.1f} ms (set-up included), {calls_b}",
          flush=True)

    # (c) golden-class 'm': K3 in the c stage, K1 for the residuals
    a = a.with_data(a.data.astype(np.complex128))
    b = b.with_data(b.data.astype(np.complex128))
    mesh.calls.clear()
    PairPlanMultiply.launches = RowTileMultiply.launches = 0
    (xm, info), wall_c = timed(lambda: solve_sharded(
        a, x, b, mesh=mesh, precision="m", tolerance=1e-9,
        max_iterations=500))
    k1_c, k3_c = PairPlanMultiply.launches, RowTileMultiply.launches
    res_c = pattern_residual(create_plan(a, x, b, device=dev), xm, a, b, dev)
    require(info["converged"] and info["residuum"] <= 1e-9,
            f"sharded golden 'm' residuum {info['residuum']:.3e}")
    require(res_c < 1e-8, f"sharded golden 'm' |AX-B|/|B| = {res_c:.3e}")
    require(k1_c == residual_checks(info["refine_rounds"]) and k3_c > 0,
            f"sharded golden 'm': {k1_c} K1, {k3_c} K3 launches for "
            f"{info['refine_rounds']} rounds")
    # each row-tile solve (the c stage and one a round) issues 2 all_gathers
    # an iteration, 1 a probe and 1 for X, and 6 all_reduces an iteration, 3
    # a probe and 1 for |B|: all_reduce - 3 all_gather = -2 a solve
    solves = 1 + info["refine_rounds"]
    ag, ar = mesh.calls["all_gather"], mesh.calls["all_reduce"]
    require(ar - 3 * ag == -2 * solves
            and ag >= 2 * info["iterations"] + 2 * solves,
            f"sharded golden 'm': {ag} all_gathers, {ar} all_reduces for "
            f"{solves} solves of {info['iterations']} iterations")
    print(f"phase 16 (c) golden-class 'm' solve_sharded: "
          f"{info['c_iterations']} c-iterations + "
          f"{info['iterations'] - info['c_iterations']} over "
          f"{info['refine_rounds']} rounds, residuum {info['residuum']:.3e}, "
          f"|AX-B|/|B| {res_c:.3e}, K3 launches {k3_c}, K1 launches {k1_c} "
          f"(phase 13: K3 {golden_m[1]}, K1 {golden_m[0]}), wall "
          f"{wall_c:.1f} ms (set-up included), "
          f"{ag / info['iterations']:.2f} all_gather + "
          f"{ar / info['iterations']:.2f} all_reduce per iteration",
          flush=True)

    # (d) FD rtb=6.75 'z' through ShardedPanelSolver (torch.matmul)
    fd6 = generate_fd_problem(rtb=6.75, reference=True)
    a, b = fd6.a_with_data(), fd6.b_with_data()
    plan = create_plan(a, fd6.x, b, device=dev)
    plan.lm, plan.ln = a.slow_block_dim, b.fast_block_dim
    mesh.calls.clear()
    (xd, info), wall_d = timed(lambda: ShardedPanelSolver(
        plan, mesh, precision="z").solve(
            a.data.real, a.data.imag, b.data.real, b.data.imag,
            tolerance=1e-9, max_iterations=2000))
    its, probes = info["iterations"], info["n_probes"]
    ref = fd6.x_reference.astype(np.float64)
    maxdev = float(np.max(np.abs(xd - ref)) / np.max(np.abs(ref)))
    require(info["return_status"] == 0 and its == dense_iterations,
            f"sharded panel FD: status {info['return_status']}, {its} "
            f"iterations, phase 7 {dense_iterations}")
    require(maxdev < 1e-5, f"sharded panel FD maxdev {maxdev:.3e}")
    calls_d = _sharded_calls(mesh, its, probes, 2)
    print(f"phase 16 (d) FD rtb=6.75 'z' ShardedPanelSolver: {its} "
          f"iterations (phase 7: {dense_iterations}), maxdev {maxdev:.3e}, "
          f"wall {wall_d:.1f} ms (set-up included), {calls_d}; phase 16 (a)-"
          f"(d) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return mesh, {"k1": {"phase 16 (a) FD z sharded_solve": k1_a,
                         "phase 16 (c) golden m sharded (residuals)": k1_c},
                  "k3": {"phase 16 (b) golden c solve_sharded rowtile": k3_b,
                         "phase 16 (c) golden m sharded (c stage, "
                         "corrections)": k3_c}}


def phase_sharded_example():
    """Phase 16 (e): the sharded example as its own process, a world of
    one on NCCL (the row tiles, the packed pairs and 'm')."""
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(root, "tfqmrgpu_tpu_torch", "examples",
                                      "tfqmrgpu_sharded_example.py")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=root))
    wall_e = time.perf_counter() - t0
    require(run.returncode == 0
            and "tfqmrgpu_sharded_example: OK" in run.stdout,
            f"sharded example exit {run.returncode}: {run.stdout}"
            f"{run.stderr[-3000:]}")
    print(f"phase 16 (e) sharded example (its own process): "
          f"{run.stdout.strip().splitlines()[-1]} in {wall_e:.1f} s",
          flush=True)


def _pairs_calls(mesh, its: int, probes: int, gathers: int) -> str:
    """Check a sharded packed-pairs solve's collectives: ``gathers``
    all_gathers in all (one a multiply when every tile is remote, and one
    for X), no edge exchange at one rank, and per iteration four column
    sums and two convergence reductions, per probe three, and one for |B|.
    Returns them per iteration."""
    ag, ar = mesh.calls["all_gather"], mesh.calls["all_reduce"]
    require(ag == gathers and mesh.calls["neighbour_exchange"] == 0,
            f"{ag} all_gathers (want {gathers}), "
            f"{mesh.calls['neighbour_exchange']} edge exchanges")
    require(ar == 6 * its + 3 * probes + 1,
            f"{ar} all_reduces for {its} iterations and {probes} probes")
    return (f"{ag / its:.2f} all_gather + {ar / its:.2f} all_reduce per "
            f"iteration")


def phase_sharded_pairs(dev, mesh, golden_pairs: tuple):
    """Phase 17: the sharded packed-pairs engine at world size 1 on NCCL,
    over phase 16's process group; ``golden_pairs`` is phase 10's (K2
    launches, X, iterations, probes)."""
    from tfqmrgpu_tpu_torch import Solver, create_plan
    from tfqmrgpu_tpu_torch.ops.pairpanel import (PairPanelMultiply,
                                                  PairPlanMultiply)
    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsLayout,
                                             ShardedPairsSolver, comm_model,
                                             solve_sharded)

    t_phase = time.perf_counter()
    k2_10, x_10, its_10, probes_10 = golden_pairs[:4]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # (a) golden 'c' through solve_sharded(engine='pairs'): every tile local
    a, x, b = golden_c_problem()
    mesh.calls.clear()
    PairPanelMultiply.launches = 0
    (xa, info), wall_a = timed(lambda: solve_sharded(
        a, x, b, mesh=mesh, engine="pairs", tolerance=1e-5,
        max_iterations=500))
    k2_a = PairPanelMultiply.launches
    its, probes = info["iterations"], info["n_probes"]
    require(info["engine"] == "pairs" and info["return_status"] == 0,
            f"sharded pairs golden 'c': {info['engine']}, status "
            f"{info['return_status']}")
    require((its, probes, k2_a) == (its_10, probes_10, k2_10),
            f"sharded pairs golden 'c': {its} iterations, {probes} probes, "
            f"{k2_a} K2 launches; phase 10: {its_10}, {probes_10}, {k2_10}")
    require(np.array_equal(xa, x_10), "sharded pairs golden 'c' X differs "
            f"from phase 10's by {np.max(np.abs(xa - x_10)):.3e}")
    calls_a = _pairs_calls(mesh, its, probes, 1)
    print(f"phase 17 (a) golden-class 'c' solve_sharded(engine='pairs') (1 x "
          f"1 on NCCL, every tile local): {its} iterations, {probes} probes, "
          f"K2 launches {k2_a} (phase 10: {its_10}, {probes_10}, {k2_10}), X "
          f"equal to phase 10's to the bit, wall {wall_a:.1f} ms (set-up "
          f"included), {calls_a}", flush=True)

    # (b) every tile remote, read through the gathered panel
    def all_remote():
        plan = create_plan(a, x, b, device=dev)
        plan.lm, plan.ln = 32, 32
        sp = ShardedPairsSolver(plan, mesh, overlap=False)
        return sp.layout, sp.solve(a.data.real, a.data.imag, b.data.real,
                                   b.data.imag, tolerance=1e-5,
                                   max_iterations=500)

    mesh.calls.clear()
    PairPanelMultiply.launches = 0
    (lay, (xb, info)), wall_b = timed(all_remote)
    require(lay.group_size == 8 and lay.n_loc == 0
            and lay.p == lay.tiles_local,
            f"overlap=False layout: G {lay.group_size}, p {lay.p}, n_loc "
            f"{lay.n_loc}")
    k2_b = PairPanelMultiply.launches
    its, probes = info["iterations"], info["n_probes"]
    require(info["return_status"] == 0 and k2_b == k2_a == 2 * its + probes,
            f"all-remote golden 'c': status {info['return_status']}, {k2_b} "
            f"K2 launches for {its} iterations, {probes} probes")
    require(np.array_equal(xb, xa), "all-remote golden 'c' X differs from "
            f"(a)'s by {np.max(np.abs(xb - xa)):.3e}")
    calls_b = _pairs_calls(mesh, its, probes, 2 * its + probes + 1)
    print(f"phase 17 (b) golden-class 'c' ShardedPairsSolver(overlap=False): "
          f"G {lay.group_size}, {lay.tiles_local} tiles all remote, {its} "
          f"iterations, K2 launches {k2_b}, X equal to (a)'s to the bit, "
          f"wall {wall_b:.1f} ms (set-up included), {calls_b}", flush=True)

    # (c) golden 'm': the c stage and the corrections on K2, residuals on K1
    a = a.with_data(a.data.astype(np.complex128))
    b = b.with_data(b.data.astype(np.complex128))
    mesh.calls.clear()
    PairPlanMultiply.launches = PairPanelMultiply.launches = 0
    (xm, info), wall_c = timed(lambda: solve_sharded(
        a, x, b, mesh=mesh, engine="pairs", precision="m", tolerance=1e-9,
        max_iterations=500))
    k1_c, k2_c = PairPlanMultiply.launches, PairPanelMultiply.launches
    res_c = pattern_residual(create_plan(a, x, b, device=dev), xm, a, b, dev)
    require(info["engine"] == "pairs" and info["converged"]
            and info["residuum"] <= 1e-9,
            f"sharded pairs golden 'm': {info['engine']}, residuum "
            f"{info['residuum']:.3e}")
    require(res_c < 1e-8, f"sharded pairs golden 'm' |AX-B|/|B| = "
            f"{res_c:.3e}")
    require(k1_c == residual_checks(info["refine_rounds"])
            and k2_c >= 2 * info["iterations"],
            f"sharded pairs golden 'm': {k1_c} K1, {k2_c} K2 launches for "
            f"{info['refine_rounds']} rounds, {info['iterations']} iterations")
    print(f"phase 17 (c) golden-class 'm' solve_sharded(engine='pairs'): "
          f"{info['c_iterations']} c-iterations + "
          f"{info['iterations'] - info['c_iterations']} over "
          f"{info['refine_rounds']} rounds, residuum {info['residuum']:.3e}, "
          f"|AX-B|/|B| {res_c:.3e}, K2 launches {k2_c}, K1 launches {k1_c}, "
          f"wall {wall_c:.1f} ms (set-up included)", flush=True)

    # (d) 48 block columns: an X panel past the row tiles' limit -> 'pairs'
    from tfqmrgpu_tpu_torch.solver import PALLAS_X_BYTE_LIMIT

    a, x, b = golden_c_problem(ncols=48)
    panel_mb = 2 * x.nrows * 32 * x.ncols * 32 * 4 / 1e6
    require(panel_mb * 1e6 > PALLAS_X_BYTE_LIMIT, f"X panel {panel_mb} MB")
    mesh.calls.clear()
    PairPanelMultiply.launches = 0
    (xd, info), wall_d = timed(lambda: solve_sharded(
        a, x, b, mesh=mesh, engine="auto", tolerance=1e-5,
        max_iterations=500))
    k2_d = PairPanelMultiply.launches
    its, probes = info["iterations"], info["n_probes"]
    require(info["engine"] == "pairs" and info["return_status"] == 0
            and k2_d == 2 * its + probes,
            f"48-column golden 'c': {info['engine']}, status "
            f"{info['return_status']}, {k2_d} K2 launches for {its} "
            f"iterations, {probes} probes")
    res_d = pattern_residual(create_plan(a, x, b, device=dev), xd, a, b, dev)
    require(res_d < 1e-4, f"48-column golden 'c' |AX-B|/|B| = {res_d:.3e}")
    calls_d = _pairs_calls(mesh, its, probes, 1)
    # the single-device packed engine on the same system: at one rank every
    # tile is local, so the same iterations and X to the bit
    s = Solver(a, x, b, precision="c", engine="pairs", device=dev)
    one = s.solve(tolerance=1e-5, max_iterations=500)
    require(one.iterations_needed == its
            and np.array_equal(s.get_matrix("X"), xd),
            f"48-column golden 'c': {its} iterations sharded, "
            f"{one.iterations_needed} on one device, X differs by "
            f"{np.max(np.abs(s.get_matrix('X') - xd)):.3e}")
    pd = s._pp_plan
    print(f"phase 17 (d) golden-class pattern, 48 block columns (X panel "
          f"{panel_mb:.1f} MB > {PALLAS_X_BYTE_LIMIT / 1e6:.1f} MB) "
          f"solve_sharded(engine='auto') -> {info['engine']} (G "
          f"{s._gp.group_size if s._gp else 1}, {pd.ntiles} tiles, ku "
          f"{pd.ku}): {its} iterations, {probes} probes, K2 launches {k2_d}, "
          f"|AX-B|/|B| {res_d:.3e}, X equal to Solver(engine='pairs')'s to "
          f"the bit, wall {wall_d:.1f} ms (set-up included), {calls_d}",
          flush=True)
    del s

    # (e) the comm model at the golden class: layouts only, no ranks
    plan = create_plan(*golden_class_patterns(), device="cpu")
    plan.lm, plan.ln = 32, 32
    for pr in (1, 2, 4, 8):
        r = comm_model.pairs_comm_report(ShardedPairsLayout(plan, pr))
        print(f"phase 17 (e) comm model golden class pr {pr}: {r['mode']}, "
              f"local tiles {r['local_tile_fraction']}, gather "
              f"{r['gather_bytes_per_multiply']} B a multiply, reductions "
              f"{r['reduction_bytes_per_iteration']} B an iteration; K2 "
              f"bound {r['t_multiply_ms']:.4f} ms a multiply, compute "
              f"{r['t_compute_ms']:.4f} ms, link {r['t_link_ms']:.4f} ms "
              f"({r['t_link_exposed_ms']:.4f} exposed) an iteration, "
              f"modelled efficiency {r['modeled_efficiency']:.4f} (NVLink "
              f"{r['assumptions']['nvlink_bytes_per_s'] / 1e9:.0f} GB/s, "
              f"data sheet)", flush=True)
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1": {"phase 17 (c) golden m sharded pairs (residuals)": k1_c},
            "k2": {"phase 17 (a) golden c solve_sharded pairs": k2_a,
                   "phase 17 (b) golden c sharded pairs all remote": k2_b,
                   "phase 17 (c) golden m sharded pairs (c stage, "
                   "corrections)": k2_c,
                   "phase 17 (d) golden 48 columns auto -> pairs": k2_d}}


TIMED_REPEATS = 3        # phase 18 (c): a warm-up, then the best of two


def phase_tuning(dev, fd, k4: dict, iterations: dict) -> dict:
    """Phase 18: the measurement and tuning layer (``profiling``,
    ``autotune``).  ``k4`` is phase 8's probe reading; ``iterations`` the
    iteration counts of phases 3, 4, 6 and 10.  Returns the launches of
    K1, K2 and K3 by path."""
    import shutil

    from tfqmrgpu_tpu_torch import Solver, autotune, profiling
    from tfqmrgpu_tpu_torch.autotune import environment
    from tfqmrgpu_tpu_torch.ops.pairpanel import (OzPairPanelMultiply,
                                                  PairPanelMultiply,
                                                  PairPlanMultiply)
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply

    t_phase = time.perf_counter()
    counters = {"k1": PairPlanMultiply, "k2": PairPanelMultiply,
                "k3": RowTileMultiply, "oz": OzPairPanelMultiply}
    by_path = {"k1": {}, "k2": {}, "k3": {}, "oz": {}}

    def zero():
        for c in counters.values():
            c.launches = 0

    def read() -> dict:
        return {k: c.launches for k, c in counters.items()}

    # (a) the sustained read+write rate of 8 adds; sets TFQ_HBM_GBPS
    sheet = profiling.device_peaks(profiling.device_kind(dev))["hbm_gbps"]
    gbps = profiling.calibrate_hbm(device=dev)
    require(0.0 < gbps <= 1.05 * sheet,
            f"calibrate_hbm {gbps:.1f} GB/s, data sheet {sheet:.0f}")
    print(f"phase 18 (a) calibrate_hbm (512 MiB float32, 8 passes a + k, "
          f"k a host constant): "
          f"{gbps:.1f} GB/s read+write ({100 * gbps / sheet:.1f}% of "
          f"{sheet:.0f}); phase 8: K4 {k4['gbps']:.1f} GB/s, copy_ "
          f"{k4['copy_gbps']:.1f} GB/s; TFQ_HBM_GBPS="
          f"{os.environ['TFQ_HBM_GBPS']}", flush=True)

    # (b) the solve's trace range, with TFQ_TRACE set and unset
    kind = torch.autograd.DeviceType
    a, x, b = golden_c_problem()
    s = Solver(a, x, b, precision="c", engine="pallas", device=dev)
    seen = {}
    for flag in ("1", None):
        with environment({"TFQ_TRACE": flag}):
            RowTileMultiply.launches = 0
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                info = s.solve(tolerance=1e-5, max_iterations=500)
                torch.cuda.synchronize()
        events = prof.events()
        seen[flag] = (
            info, RowTileMultiply.launches,
            [e.time_range for e in events if e.name == "tfq.solve.pallas"
             and e.device_type == kind.CPU],
            [e.time_range for e in events if e.device_type == kind.CUDA
             and "rowtile_spmm_kernel" in e.name])
    for flag, (info, launches, ranges, k3) in seen.items():
        require(info.return_status == 0
                and info.iterations_needed == iterations[6]
                and launches == 2 * info.iterations_needed + info.n_probes,
                f"traced golden 'c' (TFQ_TRACE={flag}): status "
                f"{info.return_status}, {info.iterations_needed} iterations "
                f"(phase 6: {iterations[6]}), {launches} K3 launches")
        by_path["k3"][f"phase 18 (b) golden c traced solve, TFQ_TRACE="
                      f"{flag or 'unset'}"] = launches
    info, launches, ranges, k3 = seen["1"]
    require(len(ranges) == 1, f"{len(ranges)} tfq.solve.pallas ranges with "
            "TFQ_TRACE=1")
    r = ranges[0]
    inside = sum(r.start <= t.start and t.end <= r.end for t in k3)
    require(0 < len(k3) <= launches and inside == len(k3),
            f"{len(k3)} K3 kernels in the profile for {launches} launches, "
            f"{inside} inside the tfq.solve.pallas range")
    require(not seen[None][2], "a tfq.solve.pallas range with TFQ_TRACE "
            "unset")
    print(f"phase 18 (b) golden-class 'c' row tiles under torch.profiler: "
          f"TFQ_TRACE=1 gives one tfq.solve.pallas range of "
          f"{(r.end - r.start) / 1e3:.1f} ms holding all {len(k3)} K3 "
          f"kernels the profile kept ({launches} launches, "
          f"{info.iterations_needed} iterations); TFQ_TRACE unset gives no "
          f"range ({len(seen[None][3])} K3 kernels)", flush=True)
    del s

    # (c) timed solves against the per-iteration roofline
    cases = (
        ("FD rtb=12.75 'z'", "k1", 3, 1e-9, 2000,
         lambda: Solver(fd.a_with_data(), fd.x, fd.b_with_data(),
                        precision="z", engine="auto", device=dev)),
        ("golden 'z'", "k1", 4, 1e-10, 500,
         lambda: Solver(*golden_z_problem(), precision="z", engine="auto",
                        device=dev)),
        ("golden 'c' row tiles", "k3", 6, 1e-5, 500,
         lambda: Solver(*golden_c_problem(), precision="c", engine="pallas",
                        device=dev)),
        ("golden 'c' packed pairs", "k2", 10, 1e-5, 500,
         lambda: Solver(*golden_c_problem(), precision="c", engine="pairs",
                        device=dev)))
    for what, kern, phase, tol, maxit, make in cases:
        s = make()
        zero()
        info, best_s, roof = profiling.timed_solve(
            s, tolerance=tol, max_iterations=maxit, repeats=TIMED_REPEATS)
        its = info.iterations_needed
        launches = read()
        require(info.return_status == 0 and its == iterations[phase],
                f"timed {what}: status {info.return_status}, {its} "
                f"iterations (phase {phase}: {iterations[phase]})")
        require(launches[kern] == TIMED_REPEATS * (2 * its + info.n_probes)
                and sum(launches.values()) == launches[kern],
                f"timed {what}: launches {launches} for {TIMED_REPEATS} "
                f"solves of {its} iterations and {info.n_probes} probes")
        fracs = (roof.fraction_of_light, roof.fraction_of_sheet_light)
        require(all(0.0 < f <= 1.05 for f in fracs),
                f"timed {what}: fractions of light {fracs}")
        by_path[kern][f"phase 18 (c) {what} timed_solve"] = launches[kern]
        print(f"phase 18 (c) {what} ({s.engine}): {its} iterations (phase "
              f"{phase}: {iterations[phase]}); {roof.flops_per_iteration:.4e} "
              f"flop and {roof.bytes_per_iteration:.4e} B an iteration"
              f"{' (vectors L2-resident)' if roof.vectors_resident else ''}, "
              f"light {roof.light_speed_s * 1e6:.1f} us ("
              f"{'compute' if roof.compute_bound else 'bandwidth'}-bound at "
              f"{roof.peak_tflops:.0f} TFlop/s, {roof.peak_gbps:.1f} GB/s); "
              f"measured {roof.measured_s * 1e6:.1f} us an iteration (CUDA "
              f"events, best of {TIMED_REPEATS - 1} after a warm-up); "
              f"fraction of light "
              f"{roof.fraction_of_light:.4f}, of sheet light "
              f"{roof.fraction_of_sheet_light:.4f}", flush=True)
        del s
    # a split mode: the ceiling is the BF16 peak over its bf16 products
    with environment({"TFQ_PALLAS_MM_PREC": "bf16x3"}):
        s = Solver(*golden_c_problem(), precision="c", engine="pallas",
                   device=dev)
    zero()
    RowTileMultiply.split_launches = 0
    info, best_s, roof = profiling.timed_solve(
        s, tolerance=1e-5, max_iterations=500, repeats=TIMED_REPEATS)
    its, split = info.iterations_needed, RowTileMultiply.split_launches
    bf16 = profiling.DEVICE_PEAKS[profiling.device_kind(dev)]["bf16_tflops"]
    explicit = profiling.solver_roofline(s, best_s / its, mm_passes=3)
    fracs = (roof.fraction_of_light, roof.fraction_of_sheet_light)
    require(info.return_status == 0 and sum(read().values()) == 0
            and split == TIMED_REPEATS * (2 * its + info.n_probes)
            and roof.peak_tflops == explicit.peak_tflops == bf16 / 3
            and all(0.0 < f <= 1.05 for f in fracs),
            f"timed golden 'c' bf16x3: status {info.return_status}, "
            f"launches {read()} and {split} split, ceiling "
            f"{roof.peak_tflops}, fractions {fracs}")
    by_path["k3s"] = {"phase 18 (c) golden c row tiles bf16x3 timed_solve":
                      split}
    print(f"phase 18 (c) golden 'c' row tiles under TFQ_PALLAS_MM_PREC="
          f"bf16x3 (mm_passes 3): {its} iterations; "
          f"{roof.bytes_per_iteration:.4e} B an iteration, light "
          f"{roof.light_speed_s * 1e6:.1f} us "
          f"({'compute' if roof.compute_bound else 'bandwidth'}-bound at "
          f"{roof.peak_tflops:.1f} TFlop/s = BF16 {bf16:.0f} / 3); measured "
          f"{roof.measured_s * 1e6:.1f} us an iteration; fraction of light "
          f"{roof.fraction_of_light:.4f}, of sheet light "
          f"{roof.fraction_of_sheet_light:.4f}", flush=True)
    del s

    # (d) autotune on the golden class, with a fresh cache
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "autotune_cache")
    shutil.rmtree(cache, ignore_errors=True)
    real = autotune.time_multiply
    moved = []

    def counted(solver, **kw):
        before = read()
        dt = real(solver, **kw)
        moved.append({k: v - before[k] for k, v in read().items()})
        return dt

    kernels = {("pallas", "c"): "k3", ("pairs", "c"): "k2",
               ("pairs", "z"): "k1"}

    def kernel_of(row, prec):
        """The counter of the kernel a candidate runs ('pairs' 'z' under
        TFQ_PAIRS_Z_OZ: the oz kernel), or None."""
        if (row["engine"], prec) == ("pairs", "z") and row["env"].get(
                "TFQ_PAIRS_Z_OZ", "0") != "0":
            return "oz"
        return kernels.get((row["engine"], prec))
    autotune.time_multiply = counted
    try:
        with environment({"TFQ_AUTOTUNE_CACHE": cache,
                          "TFQ_AUTOTUNE_SEARCH": None}):
            for prec, tol, make in (("c", 1e-5, golden_c_problem),
                                    ("z", 1e-10, golden_z_problem)):
                a, x, b = make()
                zero()
                moved.clear()
                t0 = time.perf_counter()
                s, table = autotune.autotune_solver(a, x, b, precision=prec,
                                                    device=dev)
                wall = time.perf_counter() - t0
                race = read()
                for row in table:
                    print(f"phase 18 (d) autotune '{prec}' row: "
                          f"{json.dumps(row)}", flush=True)
                timed = [row for row in table if "error" not in row]
                require(len(timed) == len(moved),
                        f"{len(timed)} timed rows, {len(moved)} measurements")
                for row, m in zip(timed, moved):
                    kern = kernel_of(row, prec)
                    want = {k: (m[k] > 0 if k == kern else m[k] == 0)
                            for k in m}
                    require(all(want.values()),
                            f"autotune '{prec}' {row}: launches {m}")
                require(all("error" not in row for row in table
                            if kernel_of(row, prec)),
                        f"autotune '{prec}': a hand-written candidate failed")
                for k, n in race.items():
                    if n:
                        by_path[k][f"phase 18 (d) autotune '{prec}' race"] = n
                hit = autotune._load_cache()[autotune._pattern_key(
                    s.plan, s.lm, s.ln, prec)]
                info_w = s.solve(tolerance=tol, max_iterations=500)
                with environment(hit["env"]):
                    direct = Solver(a, x, b, precision=prec,
                                    engine=hit["engine"], device=dev)
                info_d = direct.solve(tolerance=tol, max_iterations=500)
                require(info_w.return_status == 0
                        and info_w.iterations_needed
                        == info_d.iterations_needed
                        and np.array_equal(s.get_matrix("X"),
                                           direct.get_matrix("X")),
                        f"autotune '{prec}' winner {hit}: "
                        f"{info_w.iterations_needed} iterations, direct "
                        f"{info_d.iterations_needed}, X differs")
                del s, direct
                zero()
                moved.clear()
                t0 = time.perf_counter()
                _, again = autotune.autotune_solver(a, x, b, precision=prec,
                                                    device=dev)
                hit_wall = time.perf_counter() - t0
                require(len(again) == 1 and again[0].get("cached") is True
                        and not moved and not any(read().values()),
                        f"second autotune '{prec}': {again}, launches "
                        f"{read()}")
                print(f"phase 18 (d) autotune '{prec}' golden class: winner "
                      f"{hit['engine']} {hit['env']} "
                      f"({hit['ms_per_multiply']} ms a multiply), "
                      f"{len(table)} rows in {wall:.1f} s; the winner's "
                      f"solve ({info_w.iterations_needed} iterations) equals "
                      f"a Solver built directly to the bit; a second call "
                      f"is a cache hit in {hit_wall:.1f} s with no launch; "
                      f"race launches {race}", flush=True)
        # the local search from a packed 'pairs' start (G and r_tile moves),
        # on K2; no cache, so (d)'s entries stay as they are
        a, x, b = golden_c_problem()
        zero()
        moved.clear()
        t0 = time.perf_counter()
        with environment({"TFQ_AUTOTUNE_SEARCH": None}):
            s, table = autotune.autotune_solver(
                a, x, b, precision="c", use_cache=False, device=dev,
                candidates=[("pairs", {"TFQ_PAIRS_RTILE": "1"})])
        wall = time.perf_counter() - t0
        race = read()
        for row in table:
            print(f"phase 18 (d) autotune 'c' search row: {json.dumps(row)}",
                  flush=True)
        search = [row for row in table if row.get("search")]
        require(search and all("error" not in row for row in table)
                and len(moved) == len(table)
                and all(m["k2"] > 0 and m["k1"] == m["k3"] == 0
                        for m in moved) and s._packed,
                f"autotune 'c' search: {len(search)} search rows, "
                f"launches {moved}")
        by_path["k2"]["phase 18 (d) autotune 'c' local search"] = race["k2"]
        gp = s._gp.group_size if s._gp is not None else 1
        print(f"phase 18 (d) autotune 'c' local search from 'pairs' "
              f"TFQ_PAIRS_RTILE=1: {len(search)} search rows, each on K2; "
              f"winner G {gp}, r_tile {s._pp_plan.r_tile} "
              f"({min(r['ms_per_multiply'] for r in table)} ms a multiply) "
              f"in {wall:.1f} s; K2 launches {race['k2']}", flush=True)
        del s
    finally:
        autotune.time_multiply = real
    print(f"phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


def small_block_problem(lm: int, ln: int, mb: int = 281, deg: int = 11,
                        ncols: int = 16):
    """The golden-class pattern at a small block size with cos/sin data
    (fill_cos_sin), A made diagonally dominant by 2*deg*LM on the diagonal
    of each row's diagonal block (its first)."""
    a, x, b = golden_class_patterns(mb, deg, ncols)
    ad = cos_sin(a.nnzb, lm, lm)
    ad[::deg] += 2.0 * deg * lm * np.eye(lm)
    return (a.with_data(ad.astype(np.complex64)), x,
            b.with_data(cos_sin(b.nnzb, lm, ln).astype(np.complex64)))


def _events_ms(fn) -> tuple:
    """(``fn()``, device ms between CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_small_block(dev, fd, fd_m: tuple) -> tuple:
    """Phase 19: the small-block layer (``ops/superblock.py``,
    ``ops/rates.py``, ``tools/blocksize_sweep.py``).  ``fd_m`` is phase
    12's FD 'm' (c-iterations, refinement iterations).  Returns the
    launches of K1, K2 and K3 by path, and K2's device time (ms,
    ``blocksize_sweep.time_ms``) on each plan of (b) and (c)."""
    import shutil

    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch import autotune
    from tfqmrgpu_tpu_torch.autotune import environment
    from tfqmrgpu_tpu_torch.ops import rates, superblock
    from tfqmrgpu_tpu_torch.ops.pairpanel import (PairPanelMultiply,
                                                  PairPlanMultiply)
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply
    from tfqmrgpu_tpu_torch.tools import blocksize_sweep

    t_phase = time.perf_counter()
    counters = {"k1": PairPlanMultiply, "k2": PairPanelMultiply,
                "k3": RowTileMultiply}
    by_path = {"k1": {}, "k2": {}, "k3": {}}

    def zero():
        for c in counters.values():
            c.launches = 0

    def read() -> dict:
        return {k: c.launches for k, c in counters.items()}

    # (a) the block-size sweep: K2, K3 'c' and K1 'z' at the 15 sizes
    zero()
    rows = blocksize_sweep.sweep(
        dev, echo=lambda line: print(f"phase 19 (a) {line}", flush=True))
    failed = [f"{r['kernel']} ({r['lm']}, {r['ln']})" for r in rows
              if not r["gate_pass"]]
    require(not failed, f"sweep shapes failed their check: {failed}")
    for k, n in read().items():
        by_path[k]["phase 19 (a) block-size sweep"] = n
    engine, base = blocksize_sweep.rates_from(rows)
    engine, base = engine["c"], base["c"]
    measured = {**base, **engine}
    table = {**rates.BASE_TFLOPS["c"], **rates.ENGINE_TFLOPS["c"]}
    require(sorted(measured) == [4, 8, 16, 32],
            f"K2 rates measured at {sorted(measured)}")
    print("phase 19 (a) K2 TFlop/s measured / ops/rates.py: " + ", ".join(
        f"LM {m} {measured[m]:.3f} / {table[m]:.3f}" for m in (4, 8, 16, 32)),
        flush=True)
    plan = tt.create_plan(*golden_class_patterns(), device="cpu")
    pairs = plan.pairs.numpy().astype(np.int64)
    pair_y = np.repeat(np.arange(plan.nnzb_x), np.diff(plan.starts.numpy()))
    for lm in (8, 4):
        picks = [superblock.auto_f_row(
            pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x, lm, 8,
            candidates=(16 // lm, 32 // lm), speed_tf=speed)[0]
            for speed in (engine, None)]
        print(f"phase 19 (a) auto_f_row on the golden-class pattern at "
              f"(LM, LN) = ({lm}, 8), ungrouped: f {picks[0]} from the "
              f"measured rates, f {picks[1]} from ops/rates.py", flush=True)

    # (b) the golden class at small LM through Solver(engine='pairs')
    gate = 1e-4
    merged_ms = {}
    for lm, ln in ((8, 8), (4, 8)):
        a, x, b = small_block_problem(lm, ln)
        fine = None
        for f in (0, 2, 4) + ((8,) if lm == 4 else ()):
            with environment({"TFQ_SOLVER_SUPER": str(f)}):
                s = tt.Solver(a, x, b, precision="c", engine="pairs",
                              device=dev)
            sup, mult = s._sup, s._multiply
            require((sup is None) if f == 0 else
                    (sup is not None and sup.f_row == f),
                    f"({lm}, {ln}) TFQ_SOLVER_SUPER={f}: superblock {sup}")
            require(mult.lm == (f or 1) * lm,
                    f"({lm}, {ln}) f {f}: K2 at LM {mult.lm}")
            got = mult(s._v3)
            again = mult(s._v3)
            rel, _ = _maxdev((got,), (mult.plain(s._v3),))
            torch.cuda.synchronize()
            require(rel <= gate, f"K2 ({lm}, {ln}) f {f} maxdev {rel:.3e}")
            require(torch.equal(got, again),
                    f"K2 ({lm}, {ln}) f {f}: repeated launch differs")
            k2_ms = blocksize_sweep.time_ms(lambda: mult(s._v3), dev)
            merged_ms[f"({lm}, {ln}) f {f}"] = k2_ms
            zero()
            info = s.solve(tolerance=1e-5, max_iterations=500)
            launches = read()
            its = info.iterations_needed
            require(info.return_status == 0,
                    f"({lm}, {ln}) f {f}: status {info.return_status}")
            require(launches["k2"] == 2 * its + info.n_probes
                    and launches["k1"] == launches["k3"] == 0,
                    f"({lm}, {ln}) f {f}: launches {launches} for {its} "
                    f"iterations and {info.n_probes} probes")
            res = pattern_residual(s.plan, s.get_matrix("X"), a, b, dev)
            require(res < 1e-4, f"({lm}, {ln}) f {f}: |AX-B|/|B| {res:.3e}")
            # a second solve of 10 iterations at most, timed
            timed, ms = _events_ms(lambda: s.solve(tolerance=0.0,
                                                   max_iterations=10))
            per_it = ms / max(timed.iterations_needed, 1)
            if fine is None:
                fine = (its, per_it, k2_ms)
            require(abs(its - fine[0]) <= 3,
                    f"({lm}, {ln}) f {f}: {its} iterations, fine {fine[0]}")
            by_path["k2"][f"phase 19 (b) golden ({lm}, {ln}) 'c' "
                          f"TFQ_SOLVER_SUPER={f}"] = launches["k2"]
            pack = ("fine" if sup is None else
                    f"LM' {sup.lm2}, {2 * sup.ln} lanes, {sup.n_cells} "
                    f"cells, {sup.n_acells} A cells, MAC inflation "
                    f"{sup.mac_inflation:.2f}x")
            print(f"phase 19 (b) golden-class ({lm}, {ln}) 'c' pairs "
                  f"TFQ_SOLVER_SUPER={f} ({pack}; {s._pp_plan.ntiles} tiles, "
                  f"ku {s._pp_plan.ku}, G {s._gp.group_size if s._gp else 1}"
                  f"): K2 at LM {mult.lm} vs plain {rel:.3e}, repeated "
                  f"launch the same bits, {k2_ms:.4f} ms of device time "
                  f"({s.plan.n_pairs * 8.0 * lm * lm * ln / k2_ms / 1e9:.2f}"
                  f" TFlop/s of fine products; fine {fine[2]:.4f}); {its} "
                  f"iterations (fine {fine[0]}), {info.n_probes} probes, K2 "
                  f"launches {launches['k2']}, |AX-B|/|B| {res:.3e}; "
                  f"{per_it:.3f} ms an iteration over "
                  f"{timed.iterations_needed} (CUDA events; fine "
                  f"{fine[1]:.3f})", flush=True)
            del s, mult, got, again
        with environment({"TFQ_SOLVER_SUPER": None}):
            s = tt.Solver(a, x, b, precision="c", engine="pairs", device=dev)
            e = tt.Solver(a, x, b, precision="c", engine="auto", device=dev)
        print(f"phase 19 (b) golden-class ({lm}, {ln}) 'c': TFQ_SOLVER_SUPER "
              f"auto picks "
              + (f"f {s._sup.f_row}" if s._sup is not None else "the fine pack")
              + f"; engine='auto' picks {e.engine}", flush=True)
        del s, e

    # (c) FD rtb=12.75 'm' with the c stage fine and merged at f 2 and 4
    ad, bd = fd.a_with_data(), fd.b_with_data()
    for f in (0, 2, 4):
        with environment({"TFQ_SOLVER_SUPER": str(f)}):
            probe = tt.Solver(ad, fd.x, bd, precision="c", engine="pairs",
                              device=dev)
            sup, mult = probe._sup, probe._multiply
            got = mult(probe._v3)
            rel, _ = _maxdev((got,), (mult.plain(probe._v3),))
            require(rel <= gate and torch.equal(got, mult(probe._v3)),
                    f"K2 FD f {f} (LM {mult.lm}): maxdev {rel:.3e}")
            k2_ms = blocksize_sweep.time_ms(lambda: mult(probe._v3), dev)
            merged_ms[f"FD rtb=12.75 f {f}"] = k2_ms
            require((sup is None) if f == 0 else
                    (sup is not None and sup.f_row == f and sup.lm2 == 8 * f
                     and sup.ln == 8),
                    f"FD 'c' TFQ_SOLVER_SUPER={f}: superblock {sup}")
            zero()
            t0 = time.perf_counter()
            xs, info = tt.solve_mixed(ad, fd.x, bd, tolerance=1e-9,
                                      max_iterations=2000, engine="pairs",
                                      device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read()
        r = info.refinement
        require(info.return_status == 0 and info.residuum_reached <= 1e-9
                and r["c_engine"] == "pairs",
                f"FD 'm' f {f}: status {info.return_status}, residuum "
                f"{info.residuum_reached:.3e}, c stage on {r['c_engine']}")
        want_k1 = residual_checks(r["rounds"]) + fallback_k1(info)
        require(launches["k1"] == want_k1 and launches["k3"] == 0,
                f"FD 'm' f {f}: launches {launches}, want {want_k1} K1")
        require(launches["k2"] >= 2 * r["c_iterations"],
                f"FD 'm' f {f}: {launches['k2']} K2 launches for "
                f"{r['c_iterations']} c-iterations")
        by_path["k1"][f"phase 19 (c) FD m TFQ_SOLVER_SUPER={f} "
                      "(residuals)"] = launches["k1"]
        by_path["k2"][f"phase 19 (c) FD m TFQ_SOLVER_SUPER={f} "
                      "(c stage, corrections)"] = launches["k2"]
        pack = ("fine, G 1" if sup is None else
                f"LM' {sup.lm2}, LN {sup.ln}, {sup.n_cells} cells, MAC "
                f"inflation {sup.mac_inflation:.2f}x")
        print(f"phase 19 (c) FD rtb=12.75 solve_mixed, c stage "
              f"TFQ_SOLVER_SUPER={f} ({pack}; {probe._pp_plan.ntiles} "
              f"tiles, ku {probe._pp_plan.ku}; K2 at LM {mult.lm} vs plain "
              f"{rel:.3e}, {k2_ms:.4f} ms of device time): "
              f"{r['c_iterations']} "
              f"c-iterations + {r['iterations'] - r['c_iterations']} "
              f"refinement iterations over {r['rounds']} rounds (phase 12: "
              f"{fd_m[0]} + {fd_m[1]}; PRs 6-7: 500 + 447), 'z' fallback "
              f"{'ran' if r['fallback'] else 'not needed'}, residuum "
              f"{info.residuum_reached:.3e}, K2 launches {launches['k2']}, "
              f"K1 launches {launches['k1']} (one a float64 residual), wall "
              f"{wall_ms:.1f} ms (set-up included)", flush=True)
        del probe, mult, got

    # (d) autotune at LM 8 with a fresh cache: the superblock candidates
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "autotune_cache_19")
    shutil.rmtree(cache, ignore_errors=True)
    real = autotune.time_multiply
    moved = []

    def counted(solver, **kw):
        before = read()
        dt = real(solver, **kw)
        moved.append({k: v - before[k] for k, v in read().items()})
        return dt

    a, x, b = small_block_problem(8, 8)
    autotune.time_multiply = counted
    try:
        with environment({"TFQ_AUTOTUNE_CACHE": cache,
                          "TFQ_AUTOTUNE_SEARCH": None,
                          "TFQ_SOLVER_SUPER": None}):
            zero()
            t0 = time.perf_counter()
            s, table = autotune.autotune_solver(a, x, b, precision="c",
                                                device=dev)
            wall = time.perf_counter() - t0
    finally:
        autotune.time_multiply = real
    race = read()
    for row in table:
        print(f"phase 19 (d) autotune 'c' (8, 8) row: {json.dumps(row)}",
              flush=True)
    timed = [row for row in table if "error" not in row]
    require(len(timed) == len(moved),
            f"{len(timed)} timed rows, {len(moved)} measurements")
    sup_rows = [(row, m) for row, m in zip(timed, moved)
                if "TFQ_SOLVER_SUPER" in row["env"] and not row.get("search")]
    want = {"0", "2", "4"}
    require(sorted(row["env"]["TFQ_SOLVER_SUPER"] for row, _ in sup_rows)
            == sorted(want)
            and not any("TFQ_SOLVER_SUPER" in row["env"] for row in table
                        if "error" in row),
            f"autotune superblock rows {[r for r, _ in sup_rows]}")
    require(all(m["k2"] > 0 and m["k1"] == m["k3"] == 0
                for _, m in sup_rows),
            f"autotune superblock launches {[m for _, m in sup_rows]}")
    by_path["k2"]["phase 19 (d) autotune 'c' (8, 8) race"] = race["k2"]
    by_path["k3"]["phase 19 (d) autotune 'c' (8, 8) race"] = race["k3"]
    hit = min(timed, key=lambda row: row["ms_per_multiply"])
    print(f"phase 19 (d) autotune 'c' golden class (8, 8): {len(table)} "
          f"rows in {wall:.1f} s, the superblock candidates "
          + ", ".join(f"TFQ_SOLVER_SUPER={row['env']['TFQ_SOLVER_SUPER']} "
                      f"{row['ms_per_multiply']} ms" for row, _ in sup_rows)
          + f" (each on K2); winner {hit['engine']} {hit['env']} "
          f"({hit['ms_per_multiply']} ms a multiply); race launches {race}; "
          f"phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    shutil.rmtree(cache, ignore_errors=True)
    return by_path, merged_ms, rows


SPLIT_MODES = ("bf16", "bf16x3", "bf16x4", "bf16x6")


def f64_product(mult, x):
    """The float64 product of a K2 or K3 wrapper's operands: its plain
    version in 'highest' on float64 copies of A and x."""
    import copy

    ref = copy.copy(mult)
    ref.split, ref.mode, ref.precision = False, "highest", "highest"
    if hasattr(mult, "a_fused"):                       # K3
        ref.a_fused = mult.a_fused.double()
        return ref.plain(tuple(v.double() for v in x))
    ref.a_panels = mult.a_panels.double()              # K2
    return (ref.plain(x.double()),)


# a split kernel against its plain version, relative to the largest entry:
# both sum the same exact bf16 products in float32, in other orders
SPLIT_GATE = 1e-5


def check_split(mult, x, what: str, gate: float = SPLIT_GATE) -> float:
    """A split-mode K2 or K3 against its plain version (maxdev <= ``gate``
    of the largest entry) and the same bits on a repeated launch; returns
    the maxdev."""
    got = _as_tuple(mult(x))
    rel, _ = _maxdev(got, _as_tuple(mult.plain(x)))
    again = _as_tuple(mult(x))
    torch.cuda.synchronize()
    require(rel <= gate, f"{what} maxdev {rel:.3e} > {gate}")
    require(all(torch.equal(p, q) for p, q in zip(got, again)),
            f"{what}: repeated launch differs")
    return rel


def time_split(mult, x, kernel: str, flops: float, nbytes: float,
               products: int) -> dict:
    """A split-mode kernel at the golden class: its maxdev against the
    float64 product beside its plain version's, its device time
    (``torch.profiler``), back-to-back and single-call times, the plain
    version's time and the bound (the mode's bf16 products at the data
    sheet's BF16 rate against ``nbytes``)."""
    got, want = _as_tuple(mult(x)), f64_product(mult, x)
    plain = _as_tuple(mult.plain(x))
    rel, abs_err = _maxdev(tuple(g.double() for g in got), want)
    plain_rel, _ = _maxdev(tuple(p.double() for p in plain), want)
    rel_plain, _ = _maxdev(got, plain)
    bound_ms, bound_by = bound(nbytes, flops * products, "bf16_tflops")
    kernel_ms = _kernel_ms(lambda: mult(x), kernel)
    return dict(maxdev_f64=rel, plain_maxdev_f64=plain_rel,
                max_abs_err=abs_err, maxdev_plain=rel_plain,
                kernel_ms=kernel_ms, burst_ms=_burst_ms(lambda: mult(x)),
                ms=_time_ms(lambda: mult(x)),
                plain_ms=_time_ms(lambda: mult.plain(x)), bound_ms=bound_ms,
                bound_by=bound_by, mbytes=nbytes / 1e6)


def _gate_f64(row: dict, mode: str, what: str):
    """bf16x6 within 1e-4 of the float64 product; every other mode within
    1.05 times its plain version's own deviation from it (bf16x3 sits
    more than 1.05 times as far as bf16x4 on cos/sin data, so a bf16x4
    kernel that dropped its fourth product fails)."""
    gate = 1e-4 if mode == "bf16x6" else 1.05 * row["plain_maxdev_f64"]
    require(row["maxdev_f64"] <= gate, f"{what} {mode}: maxdev against "
            f"float64 {row['maxdev_f64']:.3e} > {gate:.3e}")


def _split_line(tag: str, mode: str, row: dict) -> str:
    return (f"{tag} {mode}: {row['kernel_ms']:.4f} ms of device time "
            f"({100 * row['bound_ms'] / row['kernel_ms']:.1f}% of the "
            f"bound), {row['burst_ms']:.4f} ms back to back, {row['ms']:.4f} "
            f"ms single; plain {row['plain_ms']:.4f} ms; maxdev against "
            f"float64 {row['maxdev_f64']:.3e} (plain "
            f"{row['plain_maxdev_f64']:.3e}), against plain "
            f"{row['maxdev_plain']:.3e}; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {row['mbytes']:.1f} MB)")


def phase_precision(dev, mesh, k3: dict, k2: dict, refs: dict) -> dict:
    """Phase 20: the reduced-precision layer.  (a) K3 and (b) K2 in the bf16
    split modes on the BF16 tensor cores, (c) golden 'c' solves under
    TFQ_PALLAS_MM_PREC and TFQ_PAIRS_MM_PREC, (d) golden 'm' with its c
    stage in bf16x3, (e) the Ozaki opt-ins TFQ_XLA_OZ and TFQ_Z_OZAKI, (f)
    the sharded engines' ``precision`` / ``mm_prec`` at world size 1 on
    phase 16's group.  ``k3`` and ``k2`` are phases 5 and 9 ('highest' at
    the golden class); ``refs`` phase 6's and 10's (iterations, ms an
    iteration) and phase 13's (c-iterations, iterations, rounds).  Returns
    the split kernels' JSON rows."""
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch import create_plan
    from tfqmrgpu_tpu_torch.autotune import environment
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem
    from tfqmrgpu_tpu_torch.ops.pairpanel import (SPLIT_PRODUCTS,
                                                  PairPanelMultiply,
                                                  PairPlanMultiply)
    from tfqmrgpu_tpu_torch.ops.pallas_spmm import RowTileMultiply
    from tfqmrgpu_tpu_torch.parallel import (ShardedPairsSolver,
                                             ShardedRowTileSolver)

    t_phase = time.perf_counter()
    K2, K3 = PairPanelMultiply, RowTileMultiply

    def zero():
        PairPlanMultiply.launches = 0
        for c in (K2, K3):
            c.launches = c.split_launches = 0

    def read() -> dict:
        return dict(k1=PairPlanMultiply.launches, k2=K2.launches,
                    k2s=K2.split_launches, k3=K3.launches,
                    k3s=K3.split_launches)

    by_path = {"k2s": {}, "k3s": {}}
    rng = np.random.default_rng(2027)
    from tfqmrgpu_tpu_torch import ALLOWED_BLOCK_SIZES

    # (a) K3 in bf16x3, bf16x4, bf16x6 at the 15 sizes and the staged shapes
    worst = {m: 0.0 for m in SPLIT_MODES[1:]}
    for lm, ln in ALLOWED_BLOCK_SIZES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=5)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for mode in worst:
            for r_tile in (1, 4):
                mult, xp, _ = _rowtile_multiply(plan, lm, ln, av, xv, dev,
                                                r_tile, precision=mode)
                worst[mode] = max(worst[mode], check_split(
                    mult, xp, f"K3 ({lm},{ln}) r_tile {r_tile} {mode}"))
    for lm, ln, ncols, r_tile in STAGED_SHAPES:
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=ncols)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for mode in worst:
            def make(slots):
                return _rowtile_multiply(plan, lm, ln, av, xv, dev, r_tile,
                                         slots, precision=mode)[:2]

            worst[mode] = max(worst[mode], check_staged(
                make, f"K3 ({lm},{ln}) x {ncols} columns, r_tile {r_tile}, "
                f"{mode}", SPLIT_GATE))
    # 'bf16' runs the exact-FP32 kernel, as the JAX kernel runs it
    plan = create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    zero()
    mult, xp, pack = _rowtile_multiply(plan, 32, 32, av, xv, dev,
                                       precision="bf16")
    href = _rowtile_multiply(plan, 32, 32, av, xv, dev)[0]
    require(all(torch.equal(p, q) for p, q in zip(mult(xp), href(xp)))
            and K3.launches == 2 and K3.split_launches == 0,
            f"K3 'bf16': launches {read()}")
    print(f"phase 20 (a) K3 split modes vs plain: 15 block sizes x r_tile "
          f"(1, 4) and {len(STAGED_SHAPES)} added shapes (misaligned x; work "
          f"lists for 1, 7 and units/2 CTAs: the same bits), worst maxdev "
          + ", ".join(f"{m} {v:.3e}" for m, v in worst.items())
          + "; 'bf16' runs the FP32 K3 (its counter 2, the split one 0, the "
          "bits of 'highest')", flush=True)
    nr, c = plan.nrows * 32, plan.ncols * 32
    flops = plan.nnzb_a * 8.0 * 32 * 32 * c
    k3_rows = {}
    for mode in worst:
        mult, xp, pack = _rowtile_multiply(plan, 32, 32, av, xv, dev,
                                           precision=mode)
        nbytes = (4 * (mult.a_planes.numel() + 4 * nr * c)
                  + 4 * pack.xcols.size + plan.nrows * plan.ncols)
        row = time_split(mult, xp, "rowtile_spmm_bf16_kernel", flops, nbytes,
                         SPLIT_PRODUCTS[mode])
        _gate_f64(row, mode, "K3 golden")
        k3_rows[mode] = row
        print(_split_line("phase 20 (a) golden-class K3", mode, row),
              flush=True)
        del mult, xp
    print(f"phase 20 (a) golden-class K3 'highest' (phase 5): "
          f"{k3['kernel_ms']:.4f} ms of device time, bound "
          f"{k3['bound_ms']:.4f} ms; library (complex64 BSR torch.sparse.mm, "
          "FP32) "
          + (f"{k3['library_ms']:.4f} ms" if k3["library_ms"] else "refused"),
          flush=True)

    # (b) K2 in the four modes: LM >= 16 with G 1 and 2, a merged pack at
    # LM' 16, the golden class at G 8
    worst2 = {m: 0.0 for m in SPLIT_MODES}
    for lm, ln in ALLOWED_BLOCK_SIZES:
        if lm < 16:
            continue
        a, x, b = random_problem(rng, mb=24, lm=lm, ln=ln, ncols=5)
        plan = create_plan(a, x, b, device=dev)
        av = rng.standard_normal((plan.nnzb_a, lm, lm, 2)) @ [1, 1j]
        xv = rng.standard_normal((plan.nnzb_x, lm, ln, 2)) @ [1, 1j]
        for mode in worst2:
            for group in (1, 2):
                mult, xf, _ = packed_multiply(plan, lm, ln, av, xv, dev,
                                              group, precision=mode)
                worst2[mode] = max(worst2[mode], check_split(
                    mult, xf, f"K2 ({lm},{ln}) G {group} {mode}"))
    a, x, b = small_block_problem(8, 8)
    merged = {}
    for mode in worst2:
        with environment({"TFQ_SOLVER_SUPER": "2",
                          "TFQ_PAIRS_MM_PREC": mode}):
            s = tt.Solver(a, x, b, precision="c", engine="pairs", device=dev)
        m = s._multiply
        require(s._sup is not None and m.lm == 16 and m.mode == mode,
                f"merged pack {s._sup}, K2 at LM {m.lm} in {m.mode}")
        merged[mode] = check_split(m, s._v3, f"K2 merged LM' 16 {mode}")
        del s, m
    print(f"phase 20 (b) K2 split modes vs plain: 6 block sizes with LM >= "
          f"16 x G (1, 2), worst maxdev "
          + ", ".join(f"{m} {v:.3e}" for m, v in worst2.items())
          + "; merged (8, 8) pack at LM' 16 "
          + ", ".join(f"{m} {v:.3e}" for m, v in merged.items())
          + "; repeated launches bit-identical", flush=True)
    plan = create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    flops = plan.n_pairs * 8.0 * 32 ** 3
    k2_rows = {}
    for mode in worst2:
        mult, xf, pplan = packed_multiply(plan, 32, 32, av, xv, dev, 8,
                                          precision=mode)
        nbytes = 4 * (mult.a_planes.numel() + 2 * xf.numel()
                      + mult.xloc.numel())
        row = time_split(mult, xf, "pairpanel_tiles_bf16_kernel", flops,
                         nbytes, SPLIT_PRODUCTS[mode])
        _gate_f64(row, mode, "K2 golden G 8")
        k2_rows[mode] = row
        print(_split_line("phase 20 (b) golden-class K2 G 8", mode, row),
              flush=True)
        del mult, xf
    print(f"phase 20 (b) golden-class K2 'highest' (phase 9, G "
          f"{k2['group']}): {k2['kernel_ms']:.4f} ms of device time, bound "
          f"{k2['bound_ms']:.4f} ms; library (complex64 BSR torch.sparse.mm, "
          "FP32) "
          + (f"{k2['library_ms']:.4f} ms" if k2["library_ms"] else "refused"),
          flush=True)

    # (c) golden 'c' solves in bf16x3 and bf16x6
    a, x, b = golden_c_problem()
    solved = {}
    for engine, knob, key in (("auto", "TFQ_PALLAS_MM_PREC", "k3s"),
                              ("pairs", "TFQ_PAIRS_MM_PREC", "k2s")):
        for mode, res_gate in (("bf16x3", 1e-3), ("bf16x6", 1e-4)):
            with environment({knob: mode}):
                s = tt.Solver(a, x, b, precision="c", engine=engine,
                              device=dev)
            want_engine = "pallas" if engine == "auto" else "pairs"
            require(s.engine == want_engine and s._multiply.mode == mode,
                    f"{engine} under {knob}={mode}: {s.engine}, "
                    f"{getattr(s._multiply, 'mode', None)}")
            if engine == "pairs":
                require(s._gp is not None and s._gp.group_size == 8,
                        f"pairs under {mode}: groups {s._gp}")
            zero()
            t0 = time.perf_counter()
            info = s.solve(tolerance=1e-5, max_iterations=500)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            n = read()
            its = info.iterations_needed
            require(info.return_status == 0,
                    f"golden 'c' {engine} {mode}: status "
                    f"{info.return_status}")
            others = sum(v for k, v in n.items() if k != key)
            require(n[key] == 2 * its + info.n_probes and others == 0,
                    f"golden 'c' {engine} {mode}: launches {n} for {its} "
                    f"iterations and {info.n_probes} probes")
            xs = s.get_matrix("X")
            res = pattern_residual(s.plan, xs, a, b, dev)
            require(res < res_gate, f"golden 'c' {engine} {mode}: "
                    f"|AX-B|/|B| {res:.3e} >= {res_gate}")
            timed, ms = _events_ms(lambda: s.solve(tolerance=0.0,
                                                   max_iterations=10))
            per_it = ms / max(timed.iterations_needed, 1)
            ref = refs[6 if engine == "auto" else 10]
            path = (f"phase 20 (c) golden c {'auto -> pallas' if engine == 'auto' else 'pairs'} "
                    f"{mode}")
            by_path[key][path] = n[key]
            solved[(want_engine, mode)] = (xs, its)
            print(f"phase 20 (c) golden-class 'c' Solver(engine='{engine}') "
                  f"-> {s.engine} under {knob}={mode}: {its} iterations, "
                  f"{info.n_probes} probes, |AX-B|/|B| {res:.3e}, split "
                  f"launches {n[key]}, wall {wall_ms:.1f} ms; {per_it:.3f} ms "
                  f"per iteration over {timed.iterations_needed} iterations "
                  f"(CUDA events); 'highest' (phase "
                  f"{6 if engine == 'auto' else 10}): {ref[0]} iterations, "
                  f"{ref[1]:.3f} ms per iteration",
                  flush=True)
            del s

    # (d) golden 'm' with its c stage in bf16x3
    am = a.with_data(a.data.astype(np.complex128))
    bm = b.with_data(b.data.astype(np.complex128))
    zero()
    with environment({"TFQ_PALLAS_MM_PREC": "bf16x3"}):
        t0 = time.perf_counter()
        xs, info = tt.bsrsv_m(am, x, bm, tolerance=1e-9, max_iterations=500,
                              device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = read()
    r = info.refinement
    require(info.return_status == 0 and info.residuum_reached <= 1e-9,
            f"golden 'm' bf16x3: status {info.return_status}, residuum "
            f"{info.residuum_reached:.3e}")
    require(r["c_engine"] == "pallas", f"golden 'm' c stage on {r['c_engine']}")
    res = pattern_residual(create_plan(am, x, bm, device=dev), xs.data, am,
                           bm, dev)
    require(res < 1e-8, f"golden 'm' bf16x3 |AX-B|/|B| = {res:.3e}")
    want_k1 = residual_checks(r["rounds"]) + fallback_k1(info)
    require(n["k1"] == want_k1 and n["k3"] == 0
            and n["k3s"] >= 2 * r["c_iterations"],
            f"golden 'm' bf16x3: launches {n}, want {want_k1} K1")
    by_path["k3s"]["phase 20 (d) golden m bf16x3 (c stage, corrections)"] = \
        n["k3s"]
    ref = refs[13]
    print(f"phase 20 (d) golden-class bsrsv_m under TFQ_PALLAS_MM_PREC="
          f"bf16x3: c stage {r['c_iterations']} iterations + "
          f"{r['iterations'] - r['c_iterations']} over {r['rounds']} rounds "
          f"(phase 13: {ref[0]} + {ref[1] - ref[0]} over {ref[2]}), "
          f"fallback {'ran' if r['fallback'] else 'not needed'}, residuum "
          f"{info.residuum_reached:.3e}, |AX-B|/|B| {res:.3e}, split K3 "
          f"{n['k3s']}, K1 {n['k1']} (one a float64 residual), wall "
          f"{wall_ms:.1f} ms", flush=True)

    # (e) the Ozaki opt-ins against the native float64 solves
    za, zx, zb = golden_z_problem()
    fd = generate_fd_problem(rtb=6.75, reference=True)
    # X against the native solve's: 1e-10 at the golden class; FD rtb=6.75
    # stops at 1e-9, since the Ozaki solve stagnates just below (the
    # residua after 60 and 100 iterations are printed), where the two
    # products' roundings leave the iterates 3.3e-10 apart on the CPU
    for name, engine, knob, abx, tol, x_gate in (
            ("golden-class 'z'", "xla", "TFQ_XLA_OZ", (za, zx, zb), 1e-10,
             1e-10),
            ("FD rtb=6.75 'z'", "dense", "TFQ_Z_OZAKI",
             (fd.a_with_data(), fd.x, fd.b_with_data()), 1e-9, 1e-9)):
        out, flat = {}, {}
        for val in ("0", "1"):
            with environment({knob: val}):
                t0 = time.perf_counter()
                s = tt.Solver(*abx, precision="z", engine=engine, device=dev)
                info = s.solve(tolerance=tol, max_iterations=2000)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            require(info.return_status == 0,
                    f"{name} {knob}={val}: status {info.return_status}")
            sliced = (s._multiply.oz_pq is not None if engine == "xla" else
                      s._multiply.__qualname__.startswith(
                          "_dense_multiply_oz"))
            require(sliced == (val == "1"),
                    f"{name} {knob}={val}: Ozaki slices {sliced}")
            out[val] = (info, s.get_matrix("X"), wall)
            if engine == "dense":       # no stop: where each one stagnates
                flat[val] = [s.solve(tolerance=0.0, max_iterations=k)
                             .residuum_reached for k in (60, 100)]
                flat[val].append(pattern_residual(
                    create_plan(*abx, device=dev), s.get_matrix("X"),
                    abx[0], abx[2], dev))
            del s
        (ni, nx, nw), (oi, ox, ow) = out["0"], out["1"]
        dx = float(np.max(np.abs(ox - nx)) / np.max(np.abs(nx)))
        res = pattern_residual(create_plan(*abx, device=dev), ox, abx[0],
                               abx[2], dev)
        require(oi.iterations_needed == ni.iterations_needed,
                f"{name} Ozaki: {oi.iterations_needed} iterations, native "
                f"{ni.iterations_needed}")
        require(dx <= x_gate and res < 1e-8,
                f"{name} Ozaki: X {dx:.3e} from native, |AX-B|/|B| "
                f"{res:.3e}")
        print(f"phase 20 (e) {name} through '{engine}' with {knob}=1: "
              f"{oi.iterations_needed} iterations (native "
              f"{ni.iterations_needed}), X {dx:.3e} from the native solve's, "
              f"|AX-B|/|B| {res:.3e}, wall {ow:.1f} ms (native {nw:.1f} ms; "
              "set-up included)", flush=True)
        if flat:
            print(f"phase 20 (e) {name} with no stop: residuum after 60 and "
                  f"100 iterations, native {flat['0'][0]:.3e} and "
                  f"{flat['0'][1]:.3e}, {knob}=1 {flat['1'][0]:.3e} and "
                  f"{flat['1'][1]:.3e}; |AX-B|/|B| at 100 native "
                  f"{flat['0'][2]:.3e}, {knob}=1 {flat['1'][2]:.3e}",
                  flush=True)

    # (f) the sharded engines at world size 1 on phase 16's group
    plan = create_plan(a, x, b, device=dev)
    plan.lm, plan.ln = 32, 32
    for cls, kw, key, eng, mode in (
            (ShardedPairsSolver, {"precision": "bf16x6"}, "k2s", "pairs",
             "bf16x6"),
            (ShardedRowTileSolver, {"mm_prec": "bf16x3", "r_tile": 2}, "k3s",
             "pallas", "bf16x3")):
        zero()
        sp = cls(plan, mesh, **kw)
        got, info = sp.solve(a.data.real, a.data.imag, b.data.real,
                             b.data.imag, tolerance=1e-5, max_iterations=500)
        n = read()
        want, its = solved[(eng, mode)]
        its_s = int(info["iterations"])
        same = bool(np.array_equal(got.astype(np.complex64), want))
        dx = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        others = sum(v for k, v in n.items() if k != key)
        require(info["return_status"] == 0 and its_s == its and same
                and others == 0 and n[key] == 2 * its + info["n_probes"],
                f"sharded {cls.__name__} {mode}: status "
                f"{info['return_status']}, {its_s} iterations ((c): {its}), "
                f"X {dx:.3e} from (c)'s, launches {n}")
        by_path[key][f"phase 20 (f) {cls.__name__} {mode} (world 1)"] = n[key]
        print(f"phase 20 (f) golden-class 'c' {cls.__name__}"
              f"({', '.join(f'{k}={v!r}' for k, v in kw.items())}) at world "
              f"size 1: {its_s} iterations ((c): {its}), X equal to (c)'s to "
              f"the bit, split launches {n[key]}", flush=True)
        del sp
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    def entry(name, replaces, rows, key, library, main_path):
        head = rows["bf16x3"]
        return {"name": name, "route": "cuda",
                "source": f"tfqmrgpu_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "mode": "bf16x3",
                "launches": by_path[key][main_path],
                "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": library,
                "kernel_ms": head["kernel_ms"], "burst_ms": head["burst_ms"],
                "modes": rows, "launches_by_path": by_path[key]}

    # the launches of each row's main path: (c)'s golden 'c' solve in the
    # head mode; every other run stays under launches_by_path
    return [entry("rowtile_spmm_bf16", "tfqmrgpu_tpu/ops/pallas_spmm.py:214",
                  k3_rows, "k3s", k3["library_ms"],
                  "phase 20 (c) golden c auto -> pallas bf16x3"),
            entry("pairpanel_tiles_bf16",
                  "tfqmrgpu_tpu/ops/pairpanel.py:1706", k2_rows, "k2s",
                  k2["library_ms"], "phase 20 (c) golden c pairs bf16x3")]


# ------------------------------------------------------------ phase 21

# K1's Ozaki bodies on the oz kernel: id -> (knobs, body, A int8).  The
# mixed body is what a 'xi8' request runs at LM % 32 != 0.
OZ_CASES = {
    "xi8": ({"TFQ_OZC_INT8": "2"}, "xi8", True),
    "ozc": ({"TFQ_OZC_INT8": "0"}, "ozc", False),
    "ozc-int8a": ({"TFQ_OZC_INT8": "1"}, "ozc", True),
    "ozc-mixed": ({"TFQ_OZC_INT8": "2"}, "ozc", True),
    "oz": ({"TFQ_OZ_COMP": "0"}, "oz", True),
    "oz-bf16": ({"TFQ_OZ_COMP": "0", "TFQ_OZ_INT8": "0"}, "oz", False),
}
OZ_KNOBS = ("TFQ_OZ_COMP", "TFQ_OZC_INT8", "TFQ_OZ_INT8")
# FD rtb=12.75 'z' under TFQ_PAIRS_Z_OZ=1: the iteration cap, and the
# residuum and X deviation a solve that stagnates at the cap must stay
# within (the JAX route stagnates at 5-8e-9 on FD, on the card and in JAX
# on the CPU, ``python tests/test_torch_oz_pairs.py fd F_ROW``; K1 reaches
# 1e-9 in 73 iterations)
OZ_FD_CAP = 300
OZ_FD_FLOOR = 1e-8
# the largest contraction each body admits, every slice int at full scale
# and of one sign: (p, q, LM, ku, A int, X int).  ozc: k (2^7 + 2)^2 <=
# 2^24 at q 8 (k 992); int8 A: k 66^2 <= 2^24 (k 3840 of 3851); xi8: p k
# 66^2 <= 2^31 (k 61600 of 61624); oz: p k (A int)(X int) <= 2^24 for the
# diagonal sums (int8 A ints <= 64 under the spare binade)
OZ_BOUND = {
    "ozc": (7, 8, 32, 31, 130, 130),
    "ozc-int8a": (8, 7, 16, 240, 66, 66),
    "xi8": (8, 7, 32, 1925, 66, 66),
    "oz": (8, 7, 16, 16, 64, 128),
    "oz-bf16": (8, 7, 16, 8, 128, 128),
}


def oz_sizes(case: str) -> list:
    """The block sizes of the oz kernel's checks: the kernel block sizes
    with LM >= 16 ('xi8' at LM 32 and 64, its mixed fallback at LM 16)."""
    from tfqmrgpu_tpu_torch.ops.pairpanel import KERNEL_BLOCK_SIZES

    sizes = [(lm, ln) for lm, ln in KERNEL_BLOCK_SIZES if lm >= 16]
    if case == "xi8":
        return [s for s in sizes if s[0] % 32 == 0]
    if case == "ozc-mixed":
        return [s for s in sizes if s[0] % 32]
    return sizes


def oz_multiply(pplan, av: np.ndarray, dev, case: str):
    """The oz kernel's multiply (``OzPairPanelMultiply``) in the body
    ``case`` over a packed plan, from complex128 A blocks."""
    from tfqmrgpu_tpu_torch.autotune import environment
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    knobs, body, a_int8 = OZ_CASES[case]
    with environment({**{k: None for k in OZ_KNOBS}, **knobs}):
        mult = pp.make_pairpanel_multiply_oz(
            pplan, *planes(av, torch.float64, dev))
    require(mult.body == body and mult.a_int8 == a_int8,
            f"oz {case}: built the {mult.body} body, int8 A {mult.a_int8}")
    return mult


def wide_blocks(rng, nnzb: int, d1: int, d2: int, lanes: bool = False):
    """Complex blocks with 10^+-6 block scales; with ``lanes`` also lanes
    far below float32's subnormals, far above its maximum and zero (the
    X prologue's float64 lanes)."""
    v = (rng.standard_normal((nnzb, d1, d2, 2)) @ [1, 1j]) * 10.0 ** (
        rng.uniform(-6, 6, (nnzb, 1, 1)))
    if lanes:
        v[:, :, 0::5] *= 1e-60
        v[:, :, 1::5] *= 1e60
        v[:, :, 2::5] = 0.0
    return v


def check_oz(mult, x: torch.Tensor, what: str):
    """The oz kernel's output (``body_out`` on the X slices of ``x``) equal
    to its plain version's to the bit, and again on a repeated launch."""
    check_oz_slices(mult, mult.slice_x(x)[0], what)


def check_oz_slices(mult, xw: torch.Tensor, what: str):
    """``check_oz`` on given X slices (lane-major, as ``slice_x`` stores
    them)."""
    from tfqmrgpu_tpu_torch.ops.pairpanel import OzPairPanelMultiply

    before = OzPairPanelMultiply.launches
    got = mult.body_out(xw)
    again = mult.body_out(xw)
    want = mult.body_plain(xw)
    torch.cuda.synchronize()
    require(OzPairPanelMultiply.launches == before + 2,
            f"{what}: {OzPairPanelMultiply.launches - before} launches")
    bits = got.view(torch.int32)
    require(torch.equal(bits, want.view(torch.int32)),
            f"{what}: {int((got != want).sum())} of {got.numel()} outputs "
            f"differ from the plain version, by up to "
            f"{float((got - want).abs().max()):.3e}")
    require(torch.equal(bits, again.view(torch.int32)),
            f"{what}: repeated launch differs")


def oz_bound_case(case: str, dev):
    """One tile at the largest contraction the body admits (``OZ_BOUND``),
    every slice of A and X at full scale and positive: (the multiply, its
    X slices)."""
    import types

    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    p, q, lm, ku, a_int, x_int = OZ_BOUND[case]
    _, body, a_int8 = OZ_CASES[case]
    xi8 = body == "xi8"
    k, m2, c = ku * lm, 2 * lm, lm
    plan = types.SimpleNamespace(
        r_tile=1, lm=lm, ln=c, ku=ku, ntiles=1, n_slots=ku,
        xloc=np.arange(ku, dtype=np.int32)[None], kcount=np.array([ku]))

    def slices(value, shape, as_int8):
        if as_int8:
            return [torch.full(shape, value, dtype=torch.int8, device=dev)
                    for _ in range(p)]
        return [torch.full(shape, value * 2.0 ** (-(s + 1) * q),
                           dtype=torch.float32, device=dev).to(torch.bfloat16)
                for s in range(p)]

    a = torch.cat(slices(a_int, (1, m2, k), a_int8), dim=1).contiguous()
    # stored lane-major, as slice_x stores them
    xw = torch.cat(slices(x_int, (2 * c, k), xi8), dim=0).t()
    sigma = torch.ones((1, lm if body != "oz" else m2, 1),
                       dtype=torch.float64, device=dev)
    mult = pp.OzPairPanelMultiply(plan, a, sigma, p, q, body != "oz", xi8,
                                  a_int8)
    return mult, xw


# The oz kernel's shapes on random slices (``oz_random_case``): case ->
# (body, A int8, q, p).  q keeps every slice int within 2^(q-1) + 2 and
# every product, and 'oz''s diagonal sums, exact at the shapes below.
OZ_RANDOM = {
    "ozc": ("ozc", False, 8, 7),
    "ozc-int8a": ("ozc", True, 7, 8),
    "xi8": ("xi8", True, 7, 8),
    "oz": ("oz", True, 7, 9),
    "oz-bf16": ("oz", False, 7, 9),
}
# shape id -> (LM, r_tile, lanes, ku, union shorter than ku, largest p):
# 2M of 32 and 128, lane counts whose last lane block reaches past LN (168
# lanes: 11 blocks of 16 and 6 of 32; 42, not a multiple of 4 either),
# unions of 0 to ku-1 slots, each body's largest p (OZ_KERNEL_P), and LM 4
# and 8 (slots padded with zero rows to the kernel's 16: A by the wrapper,
# X by slice_x).  LM below 32 becomes 32 for 'xi8', which runs at
# multiples of 32 only.
OZ_SHAPES = {
    "lm4": (4, 2, 32, 5, False, False),
    "lm8": (8, 1, 40, 4, True, False),
    "2m32": (16, 1, 32, 4, False, False),
    "2m128": (32, 2, 32, 3, False, False),
    "lanes168": (16, 1, 168, 2, False, False),
    "lanes42": (16, 1, 42, 2, False, False),
    "short": (16, 1, 64, 6, True, False),
    "pmax": (16, 1, 64, 3, False, True),
}


def oz_random_case(case: str, shape: str, dev, seed: int = 0):
    """The oz kernel's multiply in body ``case`` (``OZ_RANDOM``) on random
    slice ints at the shape ``shape`` (``OZ_SHAPES``), five tiles of a
    union over twelve X slots, built directly (no plan): (the multiply, its
    X slices stored lane-major).  A is zero past each tile's union, as the
    packed panels are."""
    import types

    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    body, a_int8, q, p = OZ_RANDOM[case]
    lm, r_tile, c, ku, short, pmax = OZ_SHAPES[shape]
    if body == "xi8":
        lm = max(lm, 32)
    if pmax:
        p = max(pp.OZ_KERNEL_P[body])
    rng = np.random.default_rng(seed)
    ntiles, n_slots, m = 5, 12, r_tile * lm
    k = ku * lm
    kcount = (rng.integers(0, ku, ntiles) if short
              else np.full(ntiles, ku)).astype(np.int32)
    xloc = rng.integers(0, n_slots, (ntiles, ku)).astype(np.int32)
    plan = types.SimpleNamespace(r_tile=r_tile, lm=lm, ln=c, ku=ku,
                                 ntiles=ntiles, n_slots=n_slots, xloc=xloc,
                                 kcount=kcount)
    cap = 2 ** (q - 1) + 2

    def slices(shape, as_int8, cap):
        ints = torch.from_numpy(rng.integers(-cap, cap + 1, (p, *shape)))
        if as_int8:
            return ints.to(torch.int8)
        scale = torch.tensor([2.0 ** (-(s + 1) * q) for s in range(p)])
        return (ints * scale.view(p, *[1] * len(shape))).to(torch.bfloat16)

    a = slices((ntiles, 2 * m, k), a_int8, min(cap, 64) if a_int8 else cap)
    keep = torch.from_numpy(np.arange(k)[None] < (kcount * lm)[:, None])
    a = torch.where(keep[None, :, None, :], a, torch.zeros((), dtype=a.dtype))
    a = a.permute(1, 0, 2, 3).reshape(ntiles, p * 2 * m, k).contiguous()
    xs = slices((2 * c, n_slots, lm), body == "xi8", cap).reshape(
        p * 2 * c, n_slots, lm)
    sigma = torch.ones((ntiles, 2 * m if body == "oz" else m, 1),
                       dtype=torch.float64)
    mult = pp.OzPairPanelMultiply(plan, a.to(dev), sigma.to(dev), p, q,
                                  body != "oz", body == "xi8", a_int8)
    # each slot padded with zero rows to the kernel's, as slice_x stores it
    xw = torch.nn.functional.pad(xs, (0, mult.klm - lm)).reshape(p * 2 * c, -1)
    return mult, xw.to(dev).t()


def _device_ms(fn, reps: int = 20) -> tuple:
    """(Device time of one call in ms, summed over the kernels and copies
    the call puts on the card, and those events a call), from
    ``torch.profiler``: the events of one call counted on a call alone,
    their mean duration over ``reps`` calls.  The trace may lose events,
    as ``_kernel_ms`` says; the mean is over those it kept, at least half,
    and a trace that kept fewer is taken once more; after that the time is
    None (not measured)."""
    def trace(n):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    per_call = max(len(trace(1)) for _ in range(3))
    for _ in range(2):
        us = trace(reps)
        if per_call and 2 * len(us) >= reps * per_call:
            return sum(us) / len(us) * per_call / 1e3, per_call
    return None, per_call


def _ms_or_not(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def phase_oz(dev, k1: dict, golden: tuple, fd, fd_ref: tuple,
             sweep_rows: list) -> dict:
    """Phase 21: K1's Ozaki modes on the oz kernel (``csrc/pairpanel_oz.cu``)
    and the JAX package's packed 'z' route under TFQ_PAIRS_Z_OZ=1.  ``k1``
    is phase 2's K1 row (its library call's time), ``golden`` phase 4's
    (iterations, X), ``fd_ref`` phase 3's (iterations, X), ``sweep_rows``
    phase 19 (a)'s block-size sweep.  Returns the kernel's JSON row."""
    import tfqmrgpu_tpu_torch as tt
    from tfqmrgpu_tpu_torch import solver as tsolver
    from tfqmrgpu_tpu_torch.autotune import environment
    from tfqmrgpu_tpu_torch.ops import rates
    from tfqmrgpu_tpu_torch.ops.blocksparse import spmm_pairs
    from tfqmrgpu_tpu_torch.ops.pairpanel import OzPairPanelMultiply
    from tfqmrgpu_tpu_torch.tools import blocksize_sweep

    t_phase = time.perf_counter()
    by_path = {}
    off = {k: None for k in OZ_KNOBS + ("TFQ_PAIRS_Z_OZ",
                                        "TFQ_SOLVER_SUPER")}

    # (a) the kernel against its plain version, to the bit
    OzPairPanelMultiply.launches = 0
    rng = np.random.default_rng(2114)
    ncase = 0
    for case in OZ_CASES:
        for lm, ln in oz_sizes(case):
            for group in (1, 2):
                for r_tile in (1, 2):
                    plan = tt.create_plan(*random_problem(
                        rng, mb=12, lm=lm, ln=ln, ncols=4), device=dev)
                    gp, pplan = pack_plan(plan, lm, ln, group, r_tile)
                    mult = oz_multiply(
                        pplan, wide_blocks(rng, plan.nnzb_a, lm, lm), dev,
                        case)
                    x = fused_x(pplan, gp, wide_blocks(
                        rng, plan.nnzb_x, lm, ln, lanes=True),
                        torch.float64, dev)
                    check_oz(mult, x, f"oz {case} ({lm}, {ln}) G {group} "
                             f"r_tile {r_tile}")
                    ncase += 1
    for case in OZ_BOUND:
        mult, xw = oz_bound_case(case, dev)
        got, want = mult.body_out(xw), mult.body_plain(xw)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"oz {case} at its depth bound: {int((got != want).sum())} "
                f"outputs differ from the plain version")
        ncase += 1
    by_path["phase 21 (a) kernel against plain"] = (
        OzPairPanelMultiply.launches)
    print(f"phase 21 (a) oz kernel vs plain: {ncase} cases (bodies "
          f"{', '.join(OZ_CASES)} at the kernel block sizes with LM >= 16 x "
          f"G (1, 2) x r_tile (1, 2) on wide-exponent data with float64 "
          f"lanes, and each body at its depth bound, "
          + ", ".join(f"{c} k {OZ_BOUND[c][2] * OZ_BOUND[c][3]}"
                      for c in OZ_BOUND)
          + "): every output to the bit, repeated launches the same bits",
          flush=True)

    # (b) the golden class per body, beside phase 2's K1
    plan = tt.create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    gp, pplan = tsolver.pack_pairs(plan, 32, 32, group_size=0, r_tile=1,
                                   lane_limit=tsolver.Z_GROUP_LANE_LIMIT)
    ref = spmm_pairs(planes(av, torch.float64, dev),
                     planes(xv, torch.float64, dev), plan.pairs[:, 0],
                     plan.pairs[:, 1], plan.pair_y(), plan.nnzb_x)
    x = fused_x(pplan, gp, xv, torch.float64, dev)
    flops = plan.n_pairs * 8.0 * 32 ** 3
    modes = {}
    for case in ("xi8", "ozc", "ozc-int8a", "oz", "oz-bf16"):
        mult = oz_multiply(pplan, av, dev, case)
        y = mult(x)
        re, im = pp_unpermute(pplan, gp, y)
        rel, abs_err = _maxdev((re, im), tuple(v.cpu() for v in ref))
        require(rel <= 1e-12, f"golden oz {case}: maxdev against float64 "
                f"{rel:.3e} > 1e-12")
        # the kernel at the main path's shape against its plain version, to
        # the bit: its raw output, and the whole multiply through it
        require(torch.equal(y.view(torch.int64),
                            mult.plain(x).view(torch.int64)),
                f"golden oz {case}: the multiply differs from its plain "
                f"version")
        xw, _ = mult.slice_x(x)
        check_oz(mult, x, f"golden oz {case}")
        products = mult.p * (mult.p + 1) // 2
        nbytes = (mult.planes.numel() * mult.planes.element_size()
                  + xw.numel() * xw.element_size()
                  + 4 * int(np.prod(mult.raw_shape)))
        bound_ms, bound_by = bound(
            nbytes, flops * products,
            "int8_tops" if mult.xi8 else "bf16_tflops")
        # the kernel's device time from the profiler, or where its traces
        # lose the events, from CUDA events around calls back to back (a
        # call's host dispatch is a small part of the kernel's time)
        kernel_ms = _kernel_ms(lambda: mult.body_out(xw),
                               "pairpanel_oz_kernel", reps=20, required=False)
        timer = "torch.profiler"
        if kernel_ms is None:
            kernel_ms = _burst_ms(lambda: mult.body_out(xw), reps=50)
            timer = ("CUDA events back to back: the profiler lost the "
                     "kernel's events")
        # the whole multiply's parts on the card: slice_x (its float64
        # transpose of x, the one X copy left, also alone), the kernel and
        # the float64 combine
        raw = mult.body_out(xw)
        _, tau = mult.slice_x(x)
        # (profiler device ms, its events a call, CUDA-event ms of calls
        # back to back)
        parts = {name: (*_device_ms(fn), _burst_ms(fn)) for name, fn in (
            ("slice_x", lambda: mult.slice_x(x)),
            ("x_transpose", lambda: x.t().contiguous()),
            ("kernel", lambda: mult.body_out(xw)),
            ("combine", lambda: mult.combine(raw, tau)),
            ("multiply", lambda: mult(x)))}
        modes[case] = dict(
            body=mult.body, p=mult.p, q=mult.q, a_int8=mult.a_int8,
            maxdev_f64=rel, max_abs_err=abs_err, maxdev_plain=0.0,
            kernel_ms=kernel_ms, kernel_timer=timer,
            burst_ms=_burst_ms(lambda: mult.body_out(xw)),
            ms=_time_ms(lambda: mult.body_out(xw)),
            multiply_ms=_time_ms(lambda: mult(x)),
            plain_ms=_time_ms(lambda: mult.body_plain(xw), reps=5, warm=1),
            bound_ms=bound_ms, bound_by=bound_by, products=products,
            mbytes=nbytes / 1e6,
            parts_ms={k: v[0] for k, v in parts.items()},
            parts_events={k: v[1] for k, v in parts.items()},
            parts_burst_ms={k: v[2] for k, v in parts.items()})
        r = modes[case]
        print(f"phase 21 (b) golden-class oz {case} ({mult.body}, p {mult.p} "
              f"q {mult.q}, G {gp.group_size if gp else 1}, {pplan.ntiles} "
              f"tiles, ku {pplan.ku}): {kernel_ms:.4f} ms of device time "
              f"({timer}; {100 * bound_ms / kernel_ms:.1f}% of the bound), "
              f"{r['burst_ms']:.4f} ms back to back, {r['ms']:.4f} ms single; "
              f"the whole multiply {r['multiply_ms']:.4f} ms; plain "
              f"{r['plain_ms']:.4f} ms; the raw output and the multiply "
              f"equal the plain version's to the bit; maxdev against "
              f"float64 {rel:.3e}; "
              f"bound {bound_ms:.4f} ms ({bound_by}, {products} products, "
              f"{nbytes / 1e6:.1f} MB); K1 {k1['ms']:.4f} ms, library "
              f"(complex128) {k1['library_ms']} ms (phase 2)", flush=True)
        share = 100 * parts["kernel"][2] / parts["multiply"][2]
        print(f"phase 21 (b) golden-class oz {case}: the multiply's parts, "
              f"ms a call (torch.profiler device time, its events a call; "
              f"CUDA events around calls back to back): "
              + ", ".join(f"{k} {_ms_or_not(v[0])} ({v[1]}), {v[2]:.4f}"
                          for k, v in parts.items())
              + f"; the kernel {share:.1f}% of the multiply (back to back)",
              flush=True)
        del mult, xw, y, raw
    by_path["phase 21 (b) golden class"] = OzPairPanelMultiply.launches - sum(
        by_path.values())

    # (c) golden 'z' through Solver(engine='pairs') under TFQ_PAIRS_Z_OZ=1
    a, xpat, b = golden_z_problem()
    its4, x4 = golden
    with environment({**off, "TFQ_PAIRS_Z_OZ": "1"}):
        s = tt.Solver(a, xpat, b, precision="z", engine="pairs", device=dev)
    mult = s._multiply
    require(isinstance(mult, OzPairPanelMultiply) and mult.body == "xi8",
            f"golden 'z' under TFQ_PAIRS_Z_OZ=1 built {type(mult).__name__}")
    OzPairPanelMultiply.launches = 0
    t0 = time.perf_counter()
    info = s.solve(tolerance=1e-10, max_iterations=500)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = OzPairPanelMultiply.launches
    require(info.return_status == 0 and info.iterations_needed == its4,
            f"golden oz solve: status {info.return_status}, "
            f"{info.iterations_needed} iterations (phase 4: {its4})")
    require(launches == 2 * info.iterations_needed + info.n_probes,
            f"golden oz solve: {launches} oz launches for "
            f"{info.iterations_needed} iterations, {info.n_probes} probes")
    xz = s.get_matrix("X")
    xdev = float(np.max(np.abs(xz - x4)) / np.max(np.abs(x4)))
    require(xdev <= 1e-10, f"golden oz X {xdev:.3e} from phase 4's")
    res = pattern_residual(s.plan, xz, a, b, dev)
    require(res < 1e-8, f"golden oz |AX-B|/|B| = {res:.3e}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    timed = s.solve(tolerance=0.0, max_iterations=10)
    end.record()
    end.synchronize()
    per_it = start.elapsed_time(end) / 10
    require(timed.return_status == 9, f"timed oz run {timed.return_status}")
    by_path["phase 21 (c) golden z Solver pairs"] = main_launches = launches
    print(f"phase 21 (c) golden-class 'z' Solver(engine='pairs') under "
          f"TFQ_PAIRS_Z_OZ=1 ({mult.body}, G "
          f"{s._gp.group_size if s._gp else 1}, {s._pp_plan.ntiles} tiles): "
          f"{info.iterations_needed} iterations (phase 4: {its4}), "
          f"{info.n_probes} probes, {launches} oz launches, X {xdev:.3e} "
          f"from phase 4's, |AX-B|/|B| {res:.3e}, wall {wall_ms:.1f} ms; "
          f"{per_it:.3f} ms per iteration over 10 (CUDA events)", flush=True)
    del s, mult

    # (d) FD rtb=12.75 'z' under TFQ_PAIRS_Z_OZ=1: 'auto', f 2 and f 4.  The
    # JAX package's route stagnates on FD above 1e-9 (its multiply is the
    # port's to the bit, tests/test_torch_oz_pairs.py): a solve that stops
    # at the cap must sit within OZ_FD_FLOOR, its X as close to phase 3's
    fd_its, fd_x = fd_ref
    fa, fb = fd.a_with_data(), fd.b_with_data()
    for sup in ("auto", "2", "4"):
        OzPairPanelMultiply.launches = 0
        with environment({**off, "TFQ_PAIRS_Z_OZ": "1",
                          "TFQ_SOLVER_SUPER": sup}):
            t0 = time.perf_counter()
            s = tt.Solver(fa, fd.x, fb, precision="z", device=dev,
                          engine="auto" if sup == "auto" else "pairs")
            info = s.solve(tolerance=1e-9, max_iterations=OZ_FD_CAP)
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = OzPairPanelMultiply.launches
        xz = s.get_matrix("X")
        xdev = float(np.max(np.abs(xz - fd_x)) / np.max(np.abs(fd_x)))
        pack = (f" (f {s._sup.f_row}, LM' {s._pp_plan.lm}, "
                f"{s._multiply.body})" if s._sup is not None else "")
        if info.return_status == 0:
            require(info.residuum_reached <= 1e-9 and xdev <= 1e-9
                    and abs(info.iterations_needed - fd_its) <= 2,
                    f"FD oz TFQ_SOLVER_SUPER={sup}: "
                    f"{info.iterations_needed} iterations (phase 3: "
                    f"{fd_its}), X {xdev:.3e} from phase 3's")
        else:
            require(info.return_status == 9
                    and info.residuum_reached <= OZ_FD_FLOOR
                    and xdev <= OZ_FD_FLOOR,
                    f"FD oz TFQ_SOLVER_SUPER={sup}: status "
                    f"{info.return_status}, residuum "
                    f"{info.residuum_reached:.3e}, X {xdev:.3e} from "
                    f"phase 3's")
        if sup != "auto" or info.engine == "pairs":
            require(info.engine == "pairs" and launches ==
                    2 * info.iterations_needed + info.n_probes,
                    f"FD oz TFQ_SOLVER_SUPER={sup}: engine {info.engine}, "
                    f"{launches} oz launches")
        by_path[f"phase 21 (d) FD z TFQ_SOLVER_SUPER={sup}"] = launches
        print(f"phase 21 (d) FD rtb=12.75 'z' Solver under TFQ_PAIRS_Z_OZ=1, "
              f"TFQ_SOLVER_SUPER={sup}: engine {info.engine}{pack}, "
              f"status {info.return_status}, "
              f"{info.iterations_needed} iterations (phase 3: {fd_its}), "
              f"residuum {info.residuum_reached:.3e}, X {xdev:.3e} from "
              f"phase 3's, {launches} oz launches, wall {wall_ms:.1f} ms "
              f"(set-up included)", flush=True)
        del s

    # (e) the sweep's 'z' rows, as ops/rates.py holds them
    engine, base = blocksize_sweep.rates_from(sweep_rows)
    oz_rows = [r for r in sweep_rows if r["kernel"] == "OZ"]
    require(len(oz_rows) == len(blocksize_sweep.OZ_SIZES)
            and all(r["gate_pass"] for r in oz_rows),
            f"sweep oz rows: {[(r['lm'], r['ln'], r['gate_pass']) for r in oz_rows]}")
    print(f"phase 21 (e) the sweep's 'z' rows (TFlop/s): ENGINE_TFLOPS 'z' "
          f"{engine['z']}, BASE_TFLOPS 'z' {base['z']}; ops/rates.py: "
          f"{rates.ENGINE_TFLOPS.get('z')}, {rates.BASE_TFLOPS.get('z')}; "
          f"phase 21 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    head = modes["xi8"]
    return {"name": "pairpanel_oz", "route": "cuda",
            "source": "tfqmrgpu_tpu_torch/csrc/pairpanel_oz.cu",
            "replaces": "tfqmrgpu_tpu/ops/pairpanel.py:1770",
            "launches": main_launches,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": k1["library_ms"],
            "kernel_ms": head["kernel_ms"], "burst_ms": head["burst_ms"],
            "modes": modes, "launches_by_path": by_path}


def pp_unpermute(pplan, gp, y: torch.Tensor) -> tuple:
    """A fused product on a packed plan -> (re, im) CPU tensors of the
    fine blocks."""
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp

    re, im = pp.unpermute_y(pplan, y.cpu().numpy())
    if gp is not None:
        re, im = pp.ungroup_blocks(gp, re), pp.ungroup_blocks(gp, im)
    return torch.from_numpy(re), torch.from_numpy(im)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    # the plain version's float32 products stay exact float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = phase_device()
    fd = generate_fd_problem(rtb=12.75, reference=True)
    timing = phase_kernel(dev, fd)
    launches, fd_iterations, fd_x = phase_fd(dev, fd)
    golden_z_iterations, golden_z_x = phase_golden(dev)
    k3 = phase_rowtile(dev)
    k3_launches, golden_c_iterations, golden_c_per_it = phase_golden_c(dev)
    dense_iterations = phase_dense(dev)
    k4 = phase_probe(dev)
    k2 = phase_packed(dev, fd)
    golden_pairs = phase_golden_pairs_c(dev)
    k2_launches = golden_pairs[0]
    fd_c_pack = phase_fd_c(dev, fd)
    k1_file_z, k1_file_m, k2_file_m, fd_m = phase_file_fd(
        dev, fd, fd_iterations, fd_c_pack)
    k1_golden_m, k3_golden_m, golden_m_counts = phase_golden_m(dev)
    k1_checkpoint = phase_checkpoint(dev, fd, fd_iterations)
    capi = phase_capi(dev, fd, card, fd_iterations,
                      launches - 2 * fd_iterations)
    mesh, sharded = phase_sharded(dev, fd, fd_x, fd_iterations, launches,
                                  golden_c_iterations, dense_iterations,
                                  (k1_golden_m, k3_golden_m))
    pairs = phase_sharded_pairs(dev, mesh, golden_pairs)
    split_kernels = phase_precision(dev, mesh, k3, k2, {
        6: (golden_c_iterations, golden_c_per_it),
        10: (golden_pairs[2], golden_pairs[4]), 13: golden_m_counts})
    for row in split_kernels:
        row["card"] = card
    torch.distributed.destroy_process_group()
    phase_sharded_example()
    tuning = phase_tuning(dev, fd, k4, {
        3: fd_iterations, 4: golden_z_iterations, 6: golden_c_iterations,
        10: golden_pairs[2]})
    split_kernels[0]["launches_by_path"].update(tuning.pop("k3s"))
    small, merged_ms, sweep_rows = phase_small_block(dev, fd, fd_m)
    oz = phase_oz(dev, timing, (golden_z_iterations, golden_z_x), fd,
                  (fd_iterations, fd_x), sweep_rows)
    oz["card"] = card
    oz["launches_by_path"].update(tuning.pop("oz"))
    print(json.dumps({"kernels": [
        {"name": "pairpanel_spmm", "route": "cuda",
         "source": "tfqmrgpu_tpu_torch/csrc/pairpanel_spmm.cu",
         "replaces": "tfqmrgpu_tpu/ops/pairpanel.py:1770",
         "launches": launches, **timing, "card": card,
         "launches_by_path": {
             "phase 3 FD z bsrsv_z": launches,
             "phase 12 FD z file": k1_file_z,
             "phase 12 FD m file (residuals)": k1_file_m,
             "phase 13 golden m (residuals)": k1_golden_m,
             "phase 14 FD z solve_checkpointed": k1_checkpoint,
             **capi["k1"], **sharded["k1"], **pairs["k1"],
             **tuning["k1"], **small["k1"]}},
        {"name": "rowtile_spmm", "route": "cuda",
         "source": "tfqmrgpu_tpu_torch/csrc/rowtile_spmm.cu",
         "replaces": "tfqmrgpu_tpu/ops/pallas_spmm.py:214",
         "launches": k3_launches, **k3, "card": card,
         "launches_by_path": {
             "phase 6 golden c": k3_launches,
             "phase 13 golden m (c stage, corrections)": k3_golden_m,
             **capi["k3"], **sharded["k3"], **tuning["k3"],
             **small["k3"]}},
        {"name": "pairpanel_tiles", "route": "cuda",
         "source": "tfqmrgpu_tpu_torch/csrc/pairpanel_tiles.cu",
         "replaces": "tfqmrgpu_tpu/ops/pairpanel.py:1706",
         "launches": k2_launches, **k2, "card": card,
         "merged_ms": merged_ms,
         "launches_by_path": {
             "phase 10 golden c pairs": k2_launches,
             "phase 12 FD m file (c stage, corrections)": k2_file_m,
             **capi["k2"], **pairs["k2"], **tuning["k2"],
             **small["k2"]}},
        {"name": "dma_probe", "route": "cuda",
         "source": "tfqmrgpu_tpu_torch/csrc/dma_probe.cu",
         "replaces": "tools/dma_probe.py:39", **k4, "card": card},
        *split_kernels,
        oz,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

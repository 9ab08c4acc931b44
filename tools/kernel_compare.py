"""One hand-written kernel against another version of its source, on one
CUDA card, in one process: the evidence behind PERF.md's same-call times
and the kernels' ptxas figures, run by hand when a kernel changes, not part
of any check.

    git show <commit>:tfqmrgpu_tpu_torch/csrc/rowtile_spmm.cu > build/other/rowtile_spmm.cu
    python3 tools/kernel_compare.py k3 build/other/rowtile_spmm.cu [NVCC FLAGS...]

The kernel is ``k1`` (``pairpanel_spmm.cu``, 'z'), ``k2``
(``pairpanel_tiles.cu``), ``k3`` (``rowtile_spmm.cu``), ``oz``
(``pairpanel_oz.cu``, K1's Ozaki modes; its first design takes the
header it includes from the source's own directory), or ``k2s`` / ``k3s``
(the bf16 split modes, ``pairpanel_tiles_bf16.cu`` / ``rowtile_spmm_bf16.cu``
over ``panel_mma.cuh``; their first design, ``mma.sync`` with X split in
the kernel, likewise):

    mkdir -p build/other
    git show 8239f41:tfqmrgpu_tpu_torch/csrc/pairpanel_oz.cu > build/other/pairpanel_oz.cu
    git show 8239f41:tfqmrgpu_tpu_torch/csrc/panel_mma.cuh > build/other/panel_mma.cuh
    python3 tools/kernel_compare.py oz build/other/pairpanel_oz.cu

    mkdir -p build/first_split
    for f in panel_mma.cuh rowtile_spmm_bf16.cu pairpanel_tiles_bf16.cu; do
      git show 4c6d664:tfqmrgpu_tpu_torch/csrc/$f > build/first_split/$f; done
    python3 tools/kernel_compare.py k3s build/first_split/rowtile_spmm_bf16.cu
    python3 tools/kernel_compare.py k2s build/first_split/pairpanel_tiles_bf16.cu

The other source is compiled alone (with ``csrc/`` on its include path and any further
flags given, e.g. ``-DTFQ_PANEL_STAGES=3`` for another ring depth of the
current source) and must export one of these C entry points:

- k1: the pair-table entry of K1's first design, ``tfq_pairpanel_spmm_f64(
  a_re, a_im, x_re, x_im, starts, pair_a, pair_x, y_re, y_im, nnzb_y, lm,
  ln, stream)``;
- oz: the current entry point ``tfq_pairpanel_oz``, which the first
  design shares (it reads int8 A slices of the bf16 bodies as they are,
  where the current one takes them re-scaled into bf16 values);
- k2s, k3s: the entry points of the first split design (4c6d664),
  ``tfq_pairpanel_tiles_bf16`` / ``tfq_rowtile_spmm_bf16`` over A's bf16
  planes as depth pairs in 32-bit words (``first_planes``) and float32 X,
  with their ``_slots``;
- k2, k3: either the current entry points (it then also exports
  ``tfq_*_slots``), or those of the first designs, ``tfq_pairpanel_tiles_f32(
  a_panels, xloc, x, y, ntiles, rlm, ku, lm, c, n_rows, stream)`` and
  ``tfq_rowtile_spmm_f32(a_fused, xcols, x_re, x_im, mask, y_re, y_im,
  ntiles, rlm, ku, lm, nr, c, ln, stream)``, which read the row-major
  panels.

Prints the card's name and power limit, ptxas' registers and spills for
every instantiation of the current source, and at the golden-class and the
FD rtb=12.75 shapes (for k2 and k3 also at the golden class cut to 264
block rows, whose units fill four rounds of an H100's CTAs exactly: what
the golden class's fifth, partly filled round costs is the two rates
apart) each version's device time per launch
(``torch.profiler``) and its time per call with 50 calls issued back to
back (CUDA events), in the order other, current, current, other; for k1
then the current version's device time under every warp grid its tile
schedule allows, for k2 and k3 the current version over equal runs of units
against its own work list, which is dealt by steps.  Both versions are checked against the plain version
(1e-12 for k1, 1e-4 for k2 and k3), and k2 and k3 also bit for bit against
each other.  For oz: the golden class ('z' packing, G 8: 562 tiles, ku 12,
256 lanes) in each of the five bodies of ``chip_smoke.py`` phase 21 (b),
both versions to the bit against the plain version, then the current one's
median single call (CUDA events), its launch's shape, and what the CUPTI
range profiler (``torch.profiler``'s ``profiler_metrics``) reads of one
call of it: the sectors the SMs read from L2 and the achieved occupancy
(``COUNTERS``), or that it read nothing and why.  For k2s and k3s: ptxas'
figures of both designs (the current one's X split pass too), then at the
golden class and at it cut to 264 block rows, in every split mode (K2 at
G 8), both versions' maxdev against the plain version (gated at 1e-4, the
'c' gate: the cos/sin data's cancellations put both designs near
``SPLIT_GATE`` there, which the random data of the checks gate) and each
one's device time per multiply (the current one's product and X split
pass, and their sum) and time per call back to back, in the order other,
current, current, other.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (_as_tuple, _burst_ms, _kernel_ms,  # noqa: E402
                        _kernels_ms, _maxdev, _rowtile_multiply, cos_sin,
                        golden_class_patterns, packed_multiply, planes,
                        require)

SOURCES = {"k1": "pairpanel_spmm.cu", "k2": "pairpanel_tiles.cu",
           "k3": "rowtile_spmm.cu", "oz": "pairpanel_oz.cu",
           "k2s": "pairpanel_tiles_bf16.cu", "k3s": "rowtile_spmm_bf16.cu"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of the first designs of K1, K2 and K3
FIRST_ABI = {"k1": ("tfq_pairpanel_spmm_f64", [_P] * 9 + [_I] * 3 + [_P]),
             "k2": ("tfq_pairpanel_tiles_f32", [_P] * 4 + [_I] * 6 + [_P]),
             "k3": ("tfq_rowtile_spmm_f32", [_P] * 7 + [_I] * 7 + [_P])}
SLOTS = {"k2": "tfq_pairpanel_tiles_slots", "k3": "tfq_rowtile_spmm_slots"}
# CUPTI metrics read of the oz kernel: the 32-byte sectors that L2 served
# to the SMs (TMA's copies included), and the active warps against the
# SM's 64
COUNTERS = ("lts__t_sectors_srcunit_tex_op_read.sum",
            "sm__warps_active.avg.pct_of_peak_sustained_active")
KERNEL = {"k2": "pairpanel_tiles_kernel", "k3": "rowtile_spmm_kernel",
          "k2s": "pairpanel_tiles_bf16_kernel",
          "k3s": "rowtile_spmm_bf16_kernel"}
# the first split design's entry points (4c6d664): A planes, X, Y, tables
FIRST_SPLIT_ABI = {
    "k2s": ("tfq_pairpanel_tiles_bf16", [_P] * 8 + [_I] * 12 + [_P]),
    "k3s": ("tfq_rowtile_spmm_bf16", [_P] * 11 + [_I] * 13 + [_P])}


def _demangled(m: re.Match) -> str:
    """kernel<ints> for a mangled kernel name and its int arguments."""
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def ptxas_report(nvcc: str, flags: tuple, src: str):
    from tfqmrgpu_tpu_torch import _build

    out = subprocess.run([nvcc, *flags, "-I", str(_build.CSRC), "-Xptxas",
                          "-v", "-c", "-o", os.devnull, src],
                         capture_output=True, text=True)
    require(out.returncode == 0, f"nvcc: {out.stderr[-2000:]}")
    name = None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d((?:pairpanel|rowtile|split)_[a-z0-9_]*?"
                          r"kernel)I", m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
        elif "Performance Loss" in line:     # wgmma serialized by ptxas
            print("ptxas: " + re.sub(
                r"_Z\S*?\d([a-z]+_[a-z0-9_]*?kernel)I((?:Li\d+E)+)\S*",
                _demangled, line), flush=True)
        elif "registers" in line or "spill" in line:
            info = re.sub(r"^\s*ptxas info\s*:\s*", "", line).strip()
            print(f"ptxas {name}: {info}", flush=True)


def other_library(which: str, path: str, nvcc: str, flags: tuple):
    """The other source as a library of its own, and whether it has the
    current entry points."""
    from tfqmrgpu_tpu_torch import _build

    lib_path = os.path.join(ROOT, "build", f"{which}_other.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    out = subprocess.run([nvcc, *flags, "-I", str(_build.CSRC), "-shared",
                          "-o", lib_path, path], capture_output=True,
                         text=True)
    require(out.returncode == 0, f"nvcc: {out.stderr[-2000:]}")
    lib = ctypes.CDLL(lib_path)
    if which == "oz":
        lib.tfq_pairpanel_oz.argtypes = _build.SIGNATURES["tfq_pairpanel_oz"]
        lib.tfq_pairpanel_oz.restype = ctypes.c_int
        # the current design stages A itself (kernel_planes); the first
        # reads the slices as they are
        return lib, hasattr(lib, "tfq_pairpanel_oz_stage_bytes")
    current = which in SLOTS and hasattr(lib, SLOTS[which])
    names = ([FIRST_ABI[which][0], SLOTS[which]] if current
             else [FIRST_ABI[which][0]])
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = (_build.SIGNATURES[name] if current
                       else FIRST_ABI[which][1])
        fn.restype = ctypes.c_int
    return lib, current


def report(label: str, runs: dict, kernels: dict):
    """Device and back-to-back times in the order other, current, current,
    other."""
    for name in ("other", "current", "current", "other"):
        fn = runs[name]
        print(f"[{label}] {name}: {_kernel_ms(fn, kernels[name]):.4f} ms of "
              f"device time, {_burst_ms(fn, reps=50):.4f} ms a call back "
              f"to back", flush=True)


def compare_k1(other, dev):
    from tfqmrgpu_tpu_torch import create_plan
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    other = getattr(other, FIRST_ABI["k1"][0])
    fd = generate_fd_problem(rtb=12.75)
    gplan = create_plan(*golden_class_patterns(), device=dev)
    fplan = create_plan(fd.a, fd.x, fd.b, device=dev)
    rng = np.random.default_rng(3)
    cases = (("golden class", gplan, cos_sin(gplan.nnzb_a, 32, 32),
              cos_sin(gplan.nnzb_x, 32, 32), 32),
             ("FD rtb=12.75", fplan, fd.a_with_data().data,
              rng.standard_normal((fplan.nnzb_x, 8, 8, 2)) @ [1, 1j], 8))
    for label, plan, av, xv, lm in cases:
        ap, xp = planes(av, torch.float64, dev), planes(xv, torch.float64, dev)
        mult = PairPlanMultiply(plan, *ap, lm)
        y = tuple(torch.empty_like(v) for v in xp)
        tables = (plan.starts, plan.pairs[:, 0].contiguous(),
                  plan.pairs[:, 1].contiguous())
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run_other():
            rc = other(*(t.data_ptr() for t in ap + xp + tables + y),
                       plan.nnzb_x, lm, lm, stream)
            require(rc == 0, f"the other K1 returned {rc}")
            return y

        runs = {"other": run_other, "current": lambda: mult(xp)}
        want = mult.plain(xp)
        for name, fn in runs.items():
            rel, _ = _maxdev(fn(), want)
            require(rel <= 1e-12, f"{label} {name} maxdev {rel:.3e}")
        s = mult.schedule
        print(f"[{label}] {plan.n_pairs} pairs; current: tiles of {s.rows} x "
              f"{s.cols}, {s.ntiles} tiles, {s.staged_bytes / 1e6:.1f} MB "
              f"staged", flush=True)
        report(label, runs, {"other": "pairpanel_spmm",
                             "current": "pairpanel_spmm_mma_kernel"})
        for grid in pp.warp_grids(lm, lm):       # the rule's alternatives
            g = PairPlanMultiply(plan, *ap, lm, grid=grid)
            s = g.schedule
            print(f"[{label}] grid {s.warps_m} x {s.warps_n} warps, tiles of "
                  f"{s.rows} x {s.cols}: {s.ntiles} tiles, {s.nsteps} steps, "
                  f"{s.staged_bytes / 1e6:.1f} MB staged, "
                  f"{_kernel_ms(lambda: g(xp), 'pairpanel_spmm_mma_kernel'):.4f}"
                  f" ms of device time", flush=True)


def compare_oz(lib, current: bool, dev):
    """The oz kernel against another version of its source at the golden
    class, per body (``current``: the other takes the staged A slices)."""
    from chip_smoke import _time_ms, fused_x, oz_multiply
    from tfqmrgpu_tpu_torch import create_plan
    from tfqmrgpu_tpu_torch import solver as tsolver
    from tfqmrgpu_tpu_torch.ops.pairpanel import OZ_BODIES

    plan = create_plan(*golden_class_patterns(), device=dev)
    av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
    gp, pplan = tsolver.pack_pairs(plan, 32, 32, group_size=0, r_tile=1,
                                   lane_limit=tsolver.Z_GROUP_LANE_LIMIT)
    x = fused_x(pplan, gp, xv, torch.float64, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for case in ("xi8", "ozc", "ozc-int8a", "oz", "oz-bf16"):
        mult = oz_multiply(pplan, av, dev, case)
        xw, _ = mult.slice_x(x)
        y = torch.empty(mult.raw_shape, dtype=torch.float32, device=dev)

        def run_other():
            a = mult.kernel_planes if current else mult.planes
            rc = lib.tfq_pairpanel_oz(
                a.data_ptr(), xw.data_ptr(), y.data_ptr(),
                mult.xloc.data_ptr(), mult.kcount.data_ptr(), mult.ntiles,
                mult.m, mult.ku, mult.klm, mult.ln, mult.x_rows, mult.p,
                mult.q, OZ_BODIES.index(mult.body), int(mult.a_int8), stream,
                None)
            require(rc == 0, f"the other oz kernel returned {rc}")
            return y

        runs = {"other": run_other, "current": lambda: mult.body_out(xw)}
        want = mult.body_plain(xw).view(torch.int32)
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            require(torch.equal(got.view(torch.int32), want),
                    f"oz {case} {name}: differs from the plain version")
        label = (f"oz {case} ({mult.body}, p {mult.p}, A "
                 f"{'int8' if mult.a_int8 else 'bf16'})")
        print(f"[{label}] {mult.ntiles} tiles, M {mult.m}, ku {mult.ku}, "
              f"{mult.ln} lanes; both versions equal the plain version to "
              f"the bit", flush=True)
        report(label, runs, {"other": "pairpanel_oz_kernel",
                             "current": "pairpanel_oz_kernel"})
        print(f"[{label}] current: {_time_ms(runs['current']):.4f} ms a "
              f"single call", flush=True)
        counter_readings(runs["current"], label)
        del mult, xw, y


def counter_readings(fn, label: str):
    """One call of ``fn`` under torch.profiler's CUPTI range profiler,
    ``COUNTERS`` per kernel: prints the values its trace holds, or that it
    holds none and why."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    path = os.path.join(ROOT, "build", "oz_counters.json")
    try:
        fn()
        torch.cuda.synchronize()
        cfg = _ExperimentalConfig(profiler_metrics=list(COUNTERS),
                                  profiler_measure_per_kernel=True)
        with profile(activities=[ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    except Exception as e:   # the profiler's own failure is the reading
        print(f"[{label}] counters: none read ({type(e).__name__}: {e})",
              flush=True)
        return
    got = [(ev.get("name", "?")[:40], {k: ev["args"][k] for k in COUNTERS
                                       if k in ev.get("args", {})})
           for ev in events if any(k in ev.get("args", {}) for k in COUNTERS)]
    cats = sorted({str(ev.get("cat")) for ev in events})
    print(f"[{label}] counters: {got if got else 'none in the trace'} "
          f"({len(events)} trace events, categories {cats})", flush=True)


def panel_cases(which: str, dev):
    """(label, multiply, x) at the golden class, at the golden class cut
    to 264 block rows (1056 units: four full rounds of the 264 CTAs an H100
    holds, where 281 block rows leave a fifth, partly filled one; the two
    rates apart are what that round costs) and at the FD rtb=12.75 shape:
    K2 packed with G = 8 and, on the FD fine cells, G = 1; K3 on the
    solver's row tiles."""
    from tfqmrgpu_tpu_torch import create_plan
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem

    fd = generate_fd_problem(rtb=12.75)
    gplan = create_plan(*golden_class_patterns(), device=dev)
    rplan = create_plan(*golden_class_patterns(mb=264), device=dev)
    fplan = create_plan(fd.a, fd.x, fd.b, device=dev)
    gav, gxv = cos_sin(gplan.nnzb_a, 32, 32), cos_sin(gplan.nnzb_x, 32, 32)
    rav, rxv = cos_sin(rplan.nnzb_a, 32, 32), cos_sin(rplan.nnzb_x, 32, 32)
    fav = fd.a_with_data().data
    fxv = np.random.default_rng(3).standard_normal(
        (fplan.nnzb_x, 8, 8, 2)) @ [1, 1j]
    if which == "k2":
        g = packed_multiply(gplan, 32, 32, gav, gxv, dev, group=8)
        r = packed_multiply(rplan, 32, 32, rav, rxv, dev, group=8)
        f = packed_multiply(fplan, 8, 8, fav, fxv, dev)
    else:
        g = _rowtile_multiply(gplan, 32, 32, gav, gxv, dev)
        r = _rowtile_multiply(rplan, 32, 32, rav, rxv, dev)
        f = _rowtile_multiply(fplan, 8, 8, fav, fxv, dev)
    return (("golden class", g[0], g[1], gplan.n_pairs),
            ("golden class, 264 block rows", r[0], r[1], rplan.n_pairs),
            ("FD rtb=12.75", f[0], f[1], fplan.n_pairs))


def compare_panel(which: str, lib, current: bool, dev):
    from tfqmrgpu_tpu_torch._build import load_kernels
    from tfqmrgpu_tpu_torch.ops import paneltiles

    entry = getattr(lib, FIRST_ABI[which][0])
    for label, mult, x, n_pairs in panel_cases(which, dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if current:
            def run_other():
                return mult.launch_with(lib, x)
        elif which == "k2":
            a_rows = mult.a_panels.contiguous()    # the row-major panels
            y = torch.empty_like(x)

            def run_other():
                rc = entry(a_rows.data_ptr(), mult.xloc.data_ptr(),
                           x.data_ptr(), y.data_ptr(), mult.ntiles, mult.rlm,
                           mult.ku, mult.lm, mult.ln, mult.n_rows, stream)
                require(rc == 0, f"the other K2 returned {rc}")
                return y
        else:
            a_rows = mult.a_fused.contiguous()
            y = tuple(torch.empty_like(v) for v in x)

            def run_other():
                rc = entry(a_rows.data_ptr(), mult.xcols.data_ptr(),
                           x[0].data_ptr(), x[1].data_ptr(),
                           mult.mask.data_ptr(), y[0].data_ptr(),
                           y[1].data_ptr(), mult.ntiles, mult.rlm, mult.ku,
                           mult.lm, mult.nr, mult.c, mult.ln, stream)
                require(rc == 0, f"the other K3 returned {rc}")
                return y

        runs = {"other": run_other, "current": lambda: mult(x)}
        want = _as_tuple(mult.plain(x))
        got = {}
        for name, fn in runs.items():
            got[name] = tuple(v.clone() for v in _as_tuple(fn()))
            rel, _ = _maxdev(got[name], want)
            require(rel <= 1e-4, f"{label} {name} maxdev {rel:.3e}")
        same = all(torch.equal(p, q)
                   for p, q in zip(got["other"], got["current"]))
        u, lt = mult.units, mult.launch_tables
        nctas = lt.args(getattr(load_kernels(), SLOTS[which]))[1]
        units = u.ngroups * u.row_blocks * -(-lt.c // lt.bn)
        print(f"[{label}] {n_pairs} pairs, {mult.ntiles} tiles of {mult.rlm} "
              f"rows, ku {mult.ku}; current: {u.nt} tile(s) a unit, "
              f"{int(u.ucount.sum())} steps, {u.staged_x_blocks} X blocks "
              f"staged a column block ({mult.ntiles * mult.ku} padded "
              f"slots), {units} units over {nctas} CTAs ({units / nctas:.2f} "
              f"rounds); other and current "
              f"{'bit-identical' if same else 'differ in bits'}", flush=True)
        report(label, runs, {"other": KERNEL[which],
                             "current": KERNEL[which]})
        # the current kernel over equal runs of units in their own order,
        # the left-over units one each to the first CTAs ("other" here),
        # against the work list it runs, dealt by steps
        items, _ = paneltiles.work_list(u, lt.c, lt.bn, nctas)
        items = items[np.lexsort((items[:, 2], items[:, 1], items[:, 0]))]
        runs = len(items) // nctas + (np.arange(nctas) < len(items) % nctas)
        starts = np.concatenate([[0], np.cumsum(runs)])
        equal = paneltiles.PanelLaunch(u, lt.lm, lt.c, dev,
                                       work=(items, starts))
        steps = u.ucount[items[:, 0]]

        def run_equal():
            mult.launch_tables = equal
            try:
                return mult(x)
            finally:
                mult.launch_tables = lt

        require(all(torch.equal(p, q) for p, q in zip(
            got["current"], _as_tuple(run_equal()))),
            f"{label}: equal runs differ in bits")
        print(f"[{label}] steps a unit {steps.min()} to {steps.max()}; most "
              f"steps on one CTA in equal runs "
              f"{np.add.reduceat(steps, starts[:-1]).max()}, mean "
              f"{steps.sum() / nctas:.1f}", flush=True)
        report(f"{label}, equal runs (other) or dealt by steps",
               {"other": run_equal, "current": lambda: mult(x)},
               {"other": KERNEL[which], "current": KERNEL[which]})


def first_planes(a_dm: torch.Tensor, precision: str) -> torch.Tensor:
    """A's bf16 planes as the first split design read them (4c6d664's
    ``paneltiles.bf16_planes``): int32 [planes, ntiles, ku*LM/2, 2*rlm],
    word (d, r) the bf16 entries of depth rows 2d (low half) and 2d+1 of
    column r of the depth-major panels [ntiles, ku*LM, 2*rlm]."""
    from tfqmrgpu_tpu_torch.ops.pairpanel import split_planes

    nt, kd, cols = a_dm.shape
    planes = torch.stack(split_planes(a_dm, precision))
    bits = planes.to(torch.bfloat16).view(torch.int16)
    pairs = bits.reshape(-1, nt, kd // 2, 2, cols).transpose(3, 4)
    return pairs.contiguous().view(torch.int32).reshape(-1, nt, kd // 2,
                                                         cols)


def compare_split(which: str, path: str, nvcc: str, flags: tuple, dev):
    """The split kernel of ``which`` (k2s, k3s) against its first design
    (``path``, 4c6d664's entry point beside its panel_mma.cuh), every mode,
    at the golden class and at it cut to 264 block rows."""
    from chip_smoke import SPLIT_PASS
    from tfqmrgpu_tpu_torch import _build, create_plan
    from tfqmrgpu_tpu_torch.ops import paneltiles
    from tfqmrgpu_tpu_torch.ops.pairpanel import SPLIT_PRODUCTS

    print("ptxas of the first design:", flush=True)
    ptxas_report(nvcc, flags, path)
    print("ptxas of the X split pass:", flush=True)
    ptxas_report(nvcc, flags, str(_build.CSRC / "split_x_bf16.cu"))
    lib_path = os.path.join(ROOT, "build", f"{which}_first.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    out = subprocess.run([nvcc, *flags, "-I", str(_build.CSRC), "-shared",
                          "-o", lib_path, path], capture_output=True,
                         text=True)
    require(out.returncode == 0, f"nvcc: {out.stderr[-2000:]}")
    lib = ctypes.CDLL(lib_path)
    name, argtypes = FIRST_SPLIT_ABI[which]
    entry, slots_fn = getattr(lib, name), getattr(lib, name + "_slots")
    entry.argtypes, slots_fn.argtypes = argtypes, [_I] * 5
    entry.restype = slots_fn.restype = ctypes.c_int
    modes = (("bf16x3", "bf16x4", "bf16x6") if which == "k3s"
             else ("bf16", "bf16x3", "bf16x4", "bf16x6"))
    kernel = KERNEL[which]
    for label, mb in (("golden class", 281), ("golden class, 264 block rows",
                                              264)):
        plan = create_plan(*golden_class_patterns(mb=mb), device=dev)
        av, xv = cos_sin(plan.nnzb_a, 32, 32), cos_sin(plan.nnzb_x, 32, 32)
        for mode in modes:
            if which == "k3s":
                mult, x, _ = _rowtile_multiply(plan, 32, 32, av, xv, dev,
                                               precision=mode)
                a_dm, c = mult.a_dm, mult.c
            else:
                mult, x, _ = packed_multiply(plan, 32, 32, av, xv, dev, 8,
                                             precision=mode)
                a_dm, c = mult.a_dm, mult.ln
            prod = SPLIT_PRODUCTS[mode]
            a_first = first_planes(a_dm, mode)
            bn = 64 if c >= 64 else 16
            launch = paneltiles.PanelLaunch(
                mult.units, mult.lm, c, dev,
                slots_fn(64, bn, mult.lm, c, prod), shape=(64, bn))
            tables, nctas = launch.args(None)
            u = mult.units
            stream = torch.cuda.current_stream(dev).cuda_stream
            if which == "k3s":
                y = tuple(torch.empty_like(v) for v in x)

                def run_first():
                    rc = entry(a_first.data_ptr(), x[0].data_ptr(),
                               x[1].data_ptr(), mult.mask.data_ptr(),
                               y[0].data_ptr(), y[1].data_ptr(), *tables,
                               nctas, mult.ntiles, mult.rlm, mult.ku,
                               mult.lm, mult.nr, mult.c, mult.ln, u.nt,
                               u.ksteps, 64, bn, prod, stream)
                    require(rc == 0, f"the first split K3 returned {rc}")
                    return y
            else:
                y = torch.empty_like(x)

                def run_first():
                    rc = entry(a_first.data_ptr(), x.data_ptr(),
                               y.data_ptr(), *tables, nctas, mult.ntiles,
                               mult.rlm, mult.ku, mult.lm, mult.ln,
                               mult.n_rows, u.nt, u.ksteps, 64, bn, prod,
                               stream)
                    require(rc == 0, f"the first split K2 returned {rc}")
                    return y

            runs = {"other": run_first, "current": lambda: mult(x)}
            want = _as_tuple(mult.plain(x))
            dev_plain = {}
            for nm, fn in runs.items():
                dev_plain[nm], _ = _maxdev(_as_tuple(fn()), want)
                require(dev_plain[nm] <= 1e-4, f"{label} {mode} {nm} maxdev "
                        f"{dev_plain[nm]:.3e}")
            lt = mult.launch_tables
            units = u.ngroups * u.row_blocks * -(-c // lt.bn)
            ncur = lt.args(None)[1]
            print(f"[{label} {mode}] {mult.ntiles} tiles of {mult.rlm} rows, "
                  f"{u.nt} a unit, {int(u.ucount.sum())} union steps; first "
                  f"design {u.ngroups * u.row_blocks * -(-c // bn)} units of "
                  f"64 x {bn} over {nctas} CTAs; current {units} units of "
                  f"{lt.bm} x {lt.bn} over {ncur} CTAs ({units / ncur:.2f} "
                  f"rounds), stages of {mult.split_ops.kc} rows; maxdev "
                  f"against the plain version {dev_plain['other']:.3e} and "
                  f"{dev_plain['current']:.3e}", flush=True)
            for nm in ("other", "current", "current", "other"):
                if nm == "other":
                    dev_ms = f"{_kernel_ms(runs[nm], kernel):.4f}"
                else:
                    each = _kernels_ms(runs[nm], (kernel, SPLIT_PASS))
                    dev_ms = (f"{each[kernel] + each[SPLIT_PASS]:.4f} (product "
                              f"{each[kernel]:.4f}, X split pass "
                              f"{each[SPLIT_PASS]:.4f})")
                print(f"[{label} {mode}] {nm}: {dev_ms} ms of device time, "
                      f"{_burst_ms(runs[nm], reps=50):.4f} ms a call back "
                      f"to back", flush=True)
            del mult, x, a_first, y, launch


def main():
    if (len(sys.argv) < 3 or sys.argv[1] not in SOURCES
            or not torch.cuda.is_available()):
        raise SystemExit("usage: kernel_compare.py k1|k2|k3|oz|k2s|k3s "
                         "OTHER_SOURCE [NVCC FLAGS...] (needs CUDA)")
    from tfqmrgpu_tpu_torch import _build

    which, path, extra = sys.argv[1], sys.argv[2], tuple(sys.argv[3:])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    ptxas_report(nvcc, _build.NVCC_FLAGS, str(_build.CSRC / SOURCES[which]))
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    if which in FIRST_SPLIT_ABI:
        compare_split(which, path, nvcc, _build.NVCC_FLAGS + extra, dev)
        return
    lib, current = other_library(which, path, nvcc, _build.NVCC_FLAGS + extra)
    if which == "k1":
        compare_k1(lib, dev)
    elif which == "oz":
        compare_oz(lib, current, dev)
    else:
        compare_panel(which, lib, current, dev)


if __name__ == "__main__":
    main()

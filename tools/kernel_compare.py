"""One hand-written kernel against another version of its source, on one
CUDA card, in one process: the evidence behind PERF.md's same-call times
and the kernels' ptxas figures, run by hand when a kernel changes, not part
of any check.

    git show <commit>:tfqmrgpu_tpu_torch/csrc/rowtile_spmm.cu > build/other/rowtile_spmm.cu
    python3 tools/kernel_compare.py k3 build/other/rowtile_spmm.cu [NVCC FLAGS...]

The kernel is ``k1`` (``pairpanel_spmm.cu``, 'z'), ``k2``
(``pairpanel_tiles.cu``), ``k3`` (``rowtile_spmm.cu``) or ``oz``
(``pairpanel_oz.cu``, K1's Ozaki modes; its first design takes the
header it includes from the source's own directory):

    mkdir -p build/other
    git show 8239f41:tfqmrgpu_tpu_torch/csrc/pairpanel_oz.cu > build/other/pairpanel_oz.cu
    git show 8239f41:tfqmrgpu_tpu_torch/csrc/panel_mma.cuh > build/other/panel_mma.cuh
    python3 tools/kernel_compare.py oz build/other/pairpanel_oz.cu

The other source is compiled alone (with ``csrc/`` on its include path and any further
flags given, e.g. ``-DTFQ_PANEL_STAGES=3`` for another ring depth of the
current source) and must export one of these C entry points:

- k1: the pair-table entry of K1's first design, ``tfq_pairpanel_spmm_f64(
  a_re, a_im, x_re, x_im, starts, pair_a, pair_x, y_re, y_im, nnzb_y, lm,
  ln, stream)``;
- oz: the current entry point ``tfq_pairpanel_oz``, which the first
  design shares (it reads int8 A slices of the bf16 bodies as they are,
  where the current one takes them re-scaled into bf16 values);
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
(``COUNTERS``), or that it read nothing and why.
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
                        _maxdev, _rowtile_multiply, cos_sin,
                        golden_class_patterns, packed_multiply, planes,
                        require)

SOURCES = {"k1": "pairpanel_spmm.cu", "k2": "pairpanel_tiles.cu",
           "k3": "rowtile_spmm.cu", "oz": "pairpanel_oz.cu"}
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
KERNEL = {"k2": "pairpanel_tiles_kernel", "k3": "rowtile_spmm_kernel"}


def ptxas_report(nvcc: str, flags: tuple, src: str):
    out = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", "-o",
                          os.devnull, src], capture_output=True, text=True)
    require(out.returncode == 0, f"nvcc: {out.stderr[-2000:]}")
    name = None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d((?:pairpanel|rowtile)_[a-z_]*kernel)I",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
        elif "Performance Loss" in line:     # wgmma serialized by ptxas
            print("ptxas: " + re.sub(r"_Z\S*?\d([a-z]+_[a-z_]*kernel)ILi(\d+)ELi(\d+)E\S*",
                                     r"\1<\2,\3>", line), flush=True)
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
                mult.q, OZ_BODIES.index(mult.body), int(mult.a_int8), stream)
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


def main():
    if (len(sys.argv) < 3 or sys.argv[1] not in SOURCES
            or not torch.cuda.is_available()):
        raise SystemExit("usage: kernel_compare.py k1|k2|k3|oz OTHER_SOURCE "
                         "[NVCC FLAGS...] (needs CUDA)")
    from tfqmrgpu_tpu_torch import _build

    which, path, extra = sys.argv[1], sys.argv[2], tuple(sys.argv[3:])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    ptxas_report(nvcc, _build.NVCC_FLAGS, str(_build.CSRC / SOURCES[which]))
    lib, current = other_library(which, path, nvcc, _build.NVCC_FLAGS + extra)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    if which == "k1":
        compare_k1(lib, dev)
    elif which == "oz":
        compare_oz(lib, current, dev)
    else:
        compare_panel(which, lib, current, dev)


if __name__ == "__main__":
    main()

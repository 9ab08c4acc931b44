"""K1 ('z') against another version of its source, on one CUDA card, in one
process: the evidence behind PERF.md's first-design and per-grid times and
K1's ptxas figures, run by hand when K1 changes, not part of any check.

    git show <commit>:tfqmrgpu_tpu_torch/csrc/pairpanel_spmm.cu > build/k1_other.cu
    python3 tools/k1_compare.py build/k1_other.cu

The other source must export the pair-table entry of K1's first design,
``tfq_pairpanel_spmm_f64(a_re, a_im, x_re, x_im, starts, pair_a, pair_x,
y_re, y_im, nnzb_y, lm, ln, stream)``.  Prints the card's name and power
limit, ptxas' registers and spills for every instantiation of the current
source, and at the golden-class and the FD rtb=12.75 shapes each version's
device time per launch (``torch.profiler``) and its time per call with 50
calls issued back to back (CUDA events), in the order other, current,
current, other, and then the current version's device time under every
warp grid its tile schedule allows.  Both versions are checked against
the plain version (1e-12).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (_burst_ms, _kernel_ms, _maxdev,  # noqa: E402
                        cos_sin, golden_class_patterns, planes, require)


def ptxas_report(nvcc: str, flags: tuple, src: str):
    out = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", "-o",
                          os.devnull, src], capture_output=True, text=True)
    require(out.returncode == 0, f"nvcc: {out.stderr[-2000:]}")
    name = None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d(pairpanel_[a-z_]*kernel)ILi(\d+)ELi(\d+)E",
                          m.group(1))
            name = f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k else m.group(1)
        elif "registers" in line or "spill" in line:
            info = re.sub(r"^\s*ptxas info\s*:\s*", "", line).strip()
            print(f"ptxas {name}: {info}", flush=True)


def other_kernel(path: str, nvcc: str, flags: tuple):
    lib_path = os.path.join(ROOT, "build", "k1_other.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    out = subprocess.run([nvcc, *flags, "-shared", "-o", lib_path, path],
                         capture_output=True, text=True)
    require(out.returncode == 0, f"nvcc: {out.stderr[-2000:]}")
    fn = ctypes.CDLL(lib_path).tfq_pairpanel_spmm_f64
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit("usage: k1_compare.py OTHER_SOURCE (needs CUDA)")
    from tfqmrgpu_tpu_torch import _build, create_plan
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem
    from tfqmrgpu_tpu_torch.ops import pairpanel as pp
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    ptxas_report(nvcc, _build.NVCC_FLAGS,
                 str(_build.CSRC / "pairpanel_spmm.cu"))
    other = other_kernel(sys.argv[1], nvcc, _build.NVCC_FLAGS)
    dev = torch.device("cuda:0")
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

        want = mult.plain(xp)
        for name, fn in (("other", run_other), ("current", lambda: mult(xp))):
            rel, _ = _maxdev(fn(), want)
            require(rel <= 1e-12, f"{label} {name} maxdev {rel:.3e}")
        s = mult.schedule
        print(f"[{label}] {plan.n_pairs} pairs; current: tiles of {s.rows} x "
              f"{s.cols}, {s.ntiles} tiles, {s.staged_bytes / 1e6:.1f} MB "
              f"staged", flush=True)
        for name, fn, kernel in (
                ("other", run_other, "pairpanel_spmm"),
                ("current", lambda: mult(xp), "pairpanel_spmm_mma_kernel"),
                ("current", lambda: mult(xp), "pairpanel_spmm_mma_kernel"),
                ("other", run_other, "pairpanel_spmm")):
            print(f"[{label}] {name}: {_kernel_ms(fn, kernel):.4f} ms of "
                  f"device time, {_burst_ms(fn, reps=50):.4f} ms a call back "
                  f"to back", flush=True)
        for grid in pp.warp_grids(lm, lm):       # the rule's alternatives
            g = PairPlanMultiply(plan, *ap, lm, grid=grid)
            s = g.schedule
            print(f"[{label}] grid {s.warps_m} x {s.warps_n} warps, tiles of "
                  f"{s.rows} x {s.cols}: {s.ntiles} tiles, {s.nsteps} steps, "
                  f"{s.staged_bytes / 1e6:.1f} MB staged, "
                  f"{_kernel_ms(lambda: g(xp), 'pairpanel_spmm_mma_kernel'):.4f}"
                  f" ms of device time", flush=True)


if __name__ == "__main__":
    main()

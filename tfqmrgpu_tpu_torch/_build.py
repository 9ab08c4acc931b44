"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
compiler process per source, all started together, and linked into one
shared library with a plain C interface, on first use, and loaded with
``ctypes``.  The library goes to ``build/kernels/<hash>/`` beside the
package, where ``<hash>`` covers the sources, their headers (``*.cuh``) and the flags, so
an edited source is rebuilt and an unchanged one is reused.  Nothing is built or
imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "libtfqmrgpu_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_ulonglong
# name -> argtypes; every kernel returns a cudaError_t as int (0 = success)
SIGNATURES = {
    # Every kernel entry ends in (stream, count): count is the kernel's
    # launch counter on the card (csrc/launch_count.cuh, launch_counts.py),
    # or null.
    # a_re, a_im, x_re, x_im, tile_steps, tile_y, step_a, step_x,
    # step_mask, y_re, y_im, ntiles, lm, ln, warps_m, warps_n, rows, cols,
    # stream, count
    "tfq_pairpanel_spmm_f64": [_P] * 11 + [_I] * 7 + [_P] * 2,
    # a_re, a_im, x_re, x_im, starts, pair_a, pair_x, y_re, y_im,
    # nnzb_y, lm, ln, stream, count
    "tfq_pairpanel_spmm_f32": [_P] * 9 + [_I] * 3 + [_P] * 2,
    # a_dm, x, y, uslot, ukidx, ucount, items, cta_start, nctas, ntiles,
    # rlm, ku, lm, c, n_rows, nt, ksteps, bm, bn, stream, count
    "tfq_pairpanel_tiles_f32": [_P] * 8 + [_I] * 11 + [_P] * 2,
    # a_dm, x_re, x_im, mask, y_re, y_im, uslot, ukidx, ucount, items,
    # cta_start, nctas, ntiles, rlm, ku, lm, nr, c, ln, nt, ksteps, bm, bn,
    # stream, count
    "tfq_rowtile_spmm_f32": [_P] * 11 + [_I] * 12 + [_P] * 2,
    # the bf16 split modes (panel_mma.cuh): maps (the tensor maps of the A
    # slabs and the X planes), y, uslot, ucount, abase, items, cta_start,
    # nctas, ntiles, rlm, lm, c, n_rows, nt, ksteps, bm, bn, kc, mode
    # (1, 3, 4 or 6 bf16 products), stream, count
    "tfq_pairpanel_tiles_bf16": [_P] * 7 + [_I] * 12 + [_P] * 2,
    # maps, mask, y_re, y_im, uslot, ucount, abase, items, cta_start,
    # nctas, ntiles, rlm, lm, nr, c, ln, nt, ksteps, bm, bn, kc, mode,
    # stream, count
    "tfq_rowtile_spmm_bf16": [_P] * 9 + [_I] * 13 + [_P] * 2,
    # their X split pass (split_x_bf16.cu): x_re, x_im, ldx, xs, nblocks,
    # lm, klm, c, nlb16, planes, stream, count
    "tfq_split_x_bf16": [_P, _P, _I, _P] + [_I] * 6 + [_P] * 2,
    # maps (256 bytes, written), a, n_boxes, xs, xrows, nlb16, planes, kc,
    # lanes
    "tfq_panel_mma_maps": [_P, _P, _I, _P] + [_I] * 5,
    # K1's Ozaki modes (pairpanel_oz.cu): a (the staged A slices), x
    # (lane-major), y, xloc, kcount, ntiles, m, ku, lm, c, rows, p, q, body,
    # a_int8, stream, count
    "tfq_pairpanel_oz": [_P] * 5 + [_I] * 10 + [_P] * 2,
    # body, p, lm -> the bytes of its stage's depth
    "tfq_pairpanel_oz_stage_bytes": [_I] * 3,
    # bm, bn, lm, c -> CTAs the card holds at once (or -cudaError_t)
    "tfq_pairpanel_tiles_slots": [_I] * 4,
    "tfq_rowtile_spmm_slots": [_I] * 4,
    # bm, bn, lm, c, mode -> the same for the split modes
    "tfq_pairpanel_tiles_bf16_slots": [_I] * 5,
    "tfq_rowtile_spmm_bf16_slots": [_I] * 5,
    # stage_bytes, n_ops -> CTAs of one wave (or -cudaError_t)
    "tfq_dma_probe_ctas": [_I] * 2,
    # x, n_ops, nsteps, rows, cols, stage_bytes, ctas, partial, out, stream
    "tfq_dma_probe_f32": [_P] + [_I] * 6 + [_P] * 3,
    # the loop's control (loop_control.cu): tau, inv_bn2, status, n, it,
    # maxit, target_bound2, stop_code, max_bound2, probe, handle,
    # set_handle, stream, count
    "tfq_loop_decide": [_P] * 3 + [_I] + [_P] * 6 + [_U, _I, _P, _P],
    # res2, status, n, tol2, max_bound2, it, residual2, target_bound2,
    # stop_code, iters_needed, n_probes, stream, count
    "tfq_loop_settle": [_P] * 2 + [_I] + [_P] * 10,
    # it, maxit, stop_code, go (or null), handle, set_handle, stream, count
    "tfq_loop_continue": [_P] * 4 + [_U, _I, _P, _P],
    # the sharded stages: tau, inv_bn2, status, n, keep_nan, part, stream,
    # count
    "tfq_loop_decide_local": [_P] * 3 + [_I, _I] + [_P] * 3,
    # part, it, maxit, target_bound2, stop_code, max_bound2, probe, handle,
    # set_handle, stream, count
    "tfq_loop_decide_finish": [_P] * 7 + [_U, _I, _P, _P],
    # res2, status, n, tol2, keep_nan, part, stream, count
    "tfq_loop_settle_local": [_P, _P, _I, _P, _I, _P, _P, _P],
    # part, tol2, max_bound2, it, residual2, target_bound2, stop_code,
    # iters_needed, n_probes, stream, count
    "tfq_loop_settle_finish": [_P] * 11,
    # the loop's vector passes (vector_passes.cu): y_re, y_im, x_re, x_im,
    # a_re, a_im, colindx, nnzb, lm, ln, scale_x, f32, stream, count
    "tfq_vec_axpay": [_P] * 7 + [_I] * 5 + [_P] * 2,
    # v_re, v_im, b_re, b_im, subset, nnzb_b, lm, ln, s, f32, stream, count
    "tfq_vec_add_rhs": [_P] * 5 + [_I] * 3 + [ctypes.c_double, _I] + [_P] * 2,
    # x_re, x_im, y_re, y_im, part, nnzb, lm, ln, dot, x_f32, y_f32,
    # stream, count
    "tfq_vec_partials": [_P] * 5 + [_I] * 6 + [_P] * 2,
    # part, planes, nnzb, ln, table, ncols, width, out, stream, count
    "tfq_vec_column_sums": [_P] + [_I] * 3 + [_P] + [_I] * 2 + [_P] * 3,
    # stream, count: one collective counted on the card
    "tfq_count": [_P, _P],
    # and its graph: stream, graph (out)
    "tfq_loop_graph_begin": [_P, ctypes.POINTER(_P)],
    # stream, handle (out)
    "tfq_loop_graph_handle": [_P, ctypes.POINTER(_U)],
    # stream, handle, kind (0 IF, 1 WHILE), node (out), body (out)
    "tfq_loop_graph_open": [_P, _U, _I, ctypes.POINTER(_P),
                            ctypes.POINTER(_P)],
    # stream, the enclosing graph, the node
    "tfq_loop_graph_close": [_P] * 3,
    # stream, graph, exec (out), why (out: int[2])
    "tfq_loop_graph_end": [_P, _P, ctypes.POINTER(_P), _P],
    "tfq_loop_graph_abort": [_P],
    "tfq_loop_graph_launch": [_P, _P],
    "tfq_loop_graph_destroy": [_P, _P],
}


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit PyTorch itself found."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates.append(shutil.which("nvcc"))
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME:
        candidates.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[pathlib.Path, float]:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns (library path, build seconds), 0 seconds when the library was
    already there.  Raises RuntimeError if nvcc is missing or fails.
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    nvcc = _nvcc()
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = path.with_name(f"{path.name}.{tag}")
    srcs = _sources()
    objs = [path.with_name(f"{src.stem}.{tag}.o") for src in srcs]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name} ({p.returncode}):\n{out}"
                  for src, p, out in zip(srcs, procs, outs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
    return path, time.perf_counter() - t0


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build if needed, load the library once per process, and declare
    every entry point's argument and result types."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib

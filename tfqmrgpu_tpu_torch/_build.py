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
# name -> argtypes; every kernel returns a cudaError_t as int (0 = success)
SIGNATURES = {
    # a_re, a_im, x_re, x_im, tile_steps, tile_y, step_a, step_x,
    # step_mask, y_re, y_im, ntiles, lm, ln, warps_m, warps_n, rows, cols,
    # stream
    "tfq_pairpanel_spmm_f64": [_P] * 11 + [_I] * 7 + [_P],
    # a_re, a_im, x_re, x_im, starts, pair_a, pair_x, y_re, y_im,
    # nnzb_y, lm, ln, stream
    "tfq_pairpanel_spmm_f32": [_P] * 9 + [_I] * 3 + [_P],
    # a_dm, x, y, uslot, ukidx, ucount, items, cta_start, nctas, ntiles,
    # rlm, ku, lm, c, n_rows, nt, ksteps, bm, bn, stream
    "tfq_pairpanel_tiles_f32": [_P] * 8 + [_I] * 11 + [_P],
    # a_dm, x_re, x_im, mask, y_re, y_im, uslot, ukidx, ucount, items,
    # cta_start, nctas, ntiles, rlm, ku, lm, nr, c, ln, nt, ksteps, bm, bn,
    # stream
    "tfq_rowtile_spmm_f32": [_P] * 11 + [_I] * 12 + [_P],
    # the bf16 split modes (panel_mma.cuh): the same arguments over the A
    # planes, then the mode (1, 3, 4 or 6 bf16 products)
    "tfq_pairpanel_tiles_bf16": [_P] * 8 + [_I] * 12 + [_P],
    "tfq_rowtile_spmm_bf16": [_P] * 11 + [_I] * 13 + [_P],
    # K1's Ozaki modes (pairpanel_oz.cu): a (the staged A slices), x
    # (lane-major), y, xloc, kcount, ntiles, m, ku, lm, c, rows, p, q, body,
    # a_int8, stream
    "tfq_pairpanel_oz": [_P] * 5 + [_I] * 10 + [_P],
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

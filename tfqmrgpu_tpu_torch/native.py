"""Build and load the port's C library, ``libtfqmrgpu_tpu_torch.so``.

The library is compiled from ``capi/`` with the host C and C++ compilers:

* ``capi/src/capi.cpp`` -- the reference-parity C API
  (``capi/include/tfqmrgpu_tpu_torch.h``); it embeds CPython and forwards
  every call to ``capi_bridge.py``, so a C, Fortran or Julia program solves
  on the CUDA card through the port;
* ``capi/src/fortran_wrappers.c`` -- the F77-style ``name_`` wrappers;
* ``capi/src/plan_builder.cpp`` -- the analysis step in C++
  (``native_plan_tables``), with no Python dependency.

One compiler process per source, all started together, then one link, into
``build/native/<hash>/`` beside the package, where ``<hash>`` covers the
sources, the header, the flags and the Python it links; the library is
written under a temporary name and renamed, so a concurrent loader never
sees half a file.  It is linked with ``-Wl,-Bsymbolic`` and loaded with
``RTLD_LOCAL``: the library's own calls bind to its own definitions even in
a process that loaded the JAX package's library (same symbol names) first.
A failed build raises.  Nothing is built when this module is imported.

    python -m tfqmrgpu_tpu_torch.native build

builds the library and prints its path and the flags that compile and link
a C program against it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import sys
import sysconfig
import time

import numpy as np

from .errors import Status, TfqmrgpuError, encode_status

CAPI = pathlib.Path(__file__).resolve().parent / "capi"
INCLUDE_DIR = CAPI / "include"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parent.parent / "build"
              / "native")
LIB_NAME = "libtfqmrgpu_tpu_torch.so"
COMMON_FLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra")
LANG_FLAGS = {".cpp": ("-x", "c++", "-std=c++17"), ".c": ("-x", "c", "-std=c11")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_CH = ctypes.c_char
_ONECALL = ([_I] * 3 + [_P, _I, _P, _P, _CH] * 3 + [_P, _P, _I, _I])
# name -> (restype, argtypes) of every exported C function
SIGNATURES = {
    "tfqmrgpuPrintError": (ctypes.c_int32, [ctypes.c_int32]),
    "tfqmrgpuGetErrorString": (ctypes.c_char_p, [ctypes.c_int32]),
    "tfqmrgpuCreateHandle": (ctypes.c_int32, [_P]),
    "tfqmrgpuDestroyHandle": (ctypes.c_int32, [_I64]),
    "tfqmrgpuSetStream": (ctypes.c_int32, [_I64, _I64]),
    "tfqmrgpuGetStream": (ctypes.c_int32, [_I64, _P]),
    "tfqmrgpuCreateWorkspace": (ctypes.c_int32, [_P, ctypes.c_size_t, _CH]),
    "tfqmrgpuDestroyWorkspace": (ctypes.c_int32, [_P]),
    "tfqmrgpu_bsrsv_allowedBlockSizes": (ctypes.c_int32, [_P, _P, _I]),
    "tfqmrgpu_bsrsv_blockSizeMissing": (ctypes.c_int32, [_I, _I]),
    "tfqmrgpu_bsrsv_createPlan": (
        ctypes.c_int32, [_I64, _P, _I] + [_P, _I, _P] * 3 + [_I, _I]),
    "tfqmrgpu_bsrsv_destroyPlan": (ctypes.c_int32, [_I64, _I64]),
    "tfqmrgpu_bsrsv_bufferSize": (
        ctypes.c_int32, [_I64, _I64, _I, _I, _I, _I, _CH, _P]),
    "tfqmrgpu_bsrsv_setBuffer": (ctypes.c_int32, [_I64, _I64, _P]),
    "tfqmrgpu_bsrsv_getBuffer": (ctypes.c_int32, [_I64, _I64, _P]),
    "tfqmrgpu_bsrsv_setMatrix": (
        ctypes.c_int32, [_I64, _I64, _CH, _P, _CH, _I, _I, _CH, _I]),
    "tfqmrgpu_bsrsv_getMatrix": (
        ctypes.c_int32, [_I64, _I64, _CH, _P, _CH, _I, _I, _CH, _I]),
    "tfqmrgpu_bsrsv_solve": (ctypes.c_int32, [_I64, _I64, ctypes.c_double, _I]),
    "tfqmrgpu_bsrsv_getInfo": (ctypes.c_int32, [_I64, _I64, _P, _P, _P, _P]),
    "tfqmrgpu_bsrsv_z": (ctypes.c_int32, _ONECALL),
    "tfqmrgpu_bsrsv_c": (ctypes.c_int32, _ONECALL),
    "tfqmrgpu_bsrsv_m": (ctypes.c_int32, _ONECALL),
    # the analysis step: (mb, index_offset, patterns..., out) -> count or
    # a negated packed status
    "tfq_plan_pairs_count": (ctypes.c_longlong, [_I, _I] + [_P] * 5),
    "tfq_plan_pairs_fill": (ctypes.c_longlong, [_I, _I] + [_P] * 5),
    "tfq_plan_subset": (ctypes.c_longlong, [_I, _I] + [_P] * 5),
    "tfq_plan_compress_columns": (
        ctypes.c_longlong, [ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P,
                            _P]),
}


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in (CAPI / "src").iterdir()
                  if p.suffix in LANG_FLAGS)


def python_flags() -> tuple[list[str], list[str]]:
    """(compile, link) flags for the Python this process runs: its headers
    and its shared libpython, found through ``sysconfig``, with the
    libpython directory as the run-time path."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError(
            "libtfqmrgpu_tpu_torch.so embeds CPython and needs a Python "
            "built with a shared libpython (Py_ENABLE_SHARED)")
    libdir = sysconfig.get_config_var("LIBDIR")
    ldlib = sysconfig.get_config_var("LDLIBRARY")       # libpython3.X.so
    name = ldlib[len("lib"):ldlib.index(".so")]
    return ([f"-I{sysconfig.get_paths()['include']}"],
            [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}"])


def library_path() -> pathlib.Path:
    """Where the library for the current sources, flags and Python lives."""
    cflags, lflags = python_flags()
    h = hashlib.sha256(" ".join((*COMMON_FLAGS, *cflags, *lflags,
                                 sys.version)).encode())
    for src in _sources() + sorted(INCLUDE_DIR.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[pathlib.Path, float]:
    """Compile ``capi/src`` unless the library for these sources exists.

    Returns (library path, build seconds), 0 seconds when the library was
    already there.  Raises RuntimeError if a compiler fails.
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    cflags, lflags = python_flags()
    cxx = os.environ.get("CXX", "g++")
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = path.with_name(f"{path.name}.{tag}")
    srcs = _sources()
    objs = [path.with_name(f"{src.stem}.{tag}.o") for src in srcs]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [cxx, *LANG_FLAGS[src.suffix], *COMMON_FLAGS, f"-I{INCLUDE_DIR}",
             *cflags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name} ({p.returncode}):\n{out}"
                  for src, p, out in zip(srcs, procs, outs) if p.returncode]
        if failed:
            raise RuntimeError(f"{cxx} failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [cxx, "-shared", "-Wl,-Bsymbolic", "-o", str(tmp),
             *map(str, objs), *lflags], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"{cxx} link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
    return path, time.perf_counter() - t0


def link_flags() -> list[str]:
    """The flags that compile and link a C program against the library
    (built if needed): its header directory, the library and its run-time
    path."""
    path, _ = build()
    return [f"-I{INCLUDE_DIR}", f"-L{path.parent}",
            f"-l{LIB_NAME[len('lib'):-len('.so')]}",
            f"-Wl,-rpath,{path.parent}"]


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library once per process (``RTLD_LOCAL``)
    and declare every entry point's argument and result types.  Inside a
    Python process the C API runs in this interpreter."""
    path, _ = build()
    lib = ctypes.CDLL(str(path), mode=ctypes.RTLD_LOCAL)
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def native_plan_tables(mb: int, index_offset: int,
                       rowptr_a, colind_a, rowptr_x, colind_x,
                       rowptr_b, colind_b):
    """The analysis step in C++: returns (starts u32[nnzbX+1],
    pairs u32[nPairs, 2], subset u32[nnzbB], colindx u16[nnzbX],
    original_cols i32[ncols]), the tables of ``plan.create_plan`` bit for
    bit, or raises TfqmrgpuError with the same packed status codes."""
    lib = load()

    def as_i32(v):
        return np.ascontiguousarray(np.asarray(v, dtype=np.int32))

    def ptr(a: np.ndarray) -> int:
        return a.ctypes.data

    rowptr_a, colind_a = as_i32(rowptr_a), as_i32(colind_a)
    rowptr_x, colind_x = as_i32(rowptr_x), as_i32(colind_x)
    rowptr_b, colind_b = as_i32(rowptr_b), as_i32(colind_b)
    nnzb_x = int(rowptr_x[mb] - index_offset)
    nnzb_b = int(rowptr_b[mb] - index_offset)
    patterns = [ptr(v) for v in (rowptr_a, colind_a, rowptr_x, colind_x)]

    starts = np.zeros(nnzb_x + 1, dtype=np.uint32)
    n = lib.tfq_plan_pairs_count(mb, index_offset, *patterns, ptr(starts))
    if n < 0:
        raise TfqmrgpuError(int(-n), "native pairs_count")
    pairs = np.zeros((int(n), 2), dtype=np.uint32)
    n2 = lib.tfq_plan_pairs_fill(mb, index_offset, *patterns, ptr(pairs))
    if n2 != n:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR),
                            f"native pairs_fill count mismatch {n2} != {n}")

    subset = np.zeros(max(nnzb_b, 1), dtype=np.uint32)
    st = lib.tfq_plan_subset(mb, index_offset, ptr(rowptr_x), ptr(colind_x),
                             ptr(rowptr_b), ptr(colind_b), ptr(subset))
    if st < 0:
        raise TfqmrgpuError(int(-st), "native subset")
    subset = subset[:nnzb_b]

    colindx = np.zeros(nnzb_x, dtype=np.uint16)
    original = np.zeros(1 << 16, dtype=np.int32)
    nc = lib.tfq_plan_compress_columns(nnzb_x, ptr(colind_x), nnzb_b,
                                       ptr(subset), ptr(colindx),
                                       ptr(original))
    if nc < 0:
        raise TfqmrgpuError(int(-nc), "native compress_columns")
    return starts, pairs, subset, colindx, original[: int(nc)].copy()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m tfqmrgpu_tpu_torch.native",
        description="Build libtfqmrgpu_tpu_torch.so and print how to link "
                    "against it.")
    parser.add_argument("command", choices=["build"])
    parser.parse_args(argv)
    path, seconds = build()
    print(f"{path} (built in {seconds:.1f} s)" if seconds else str(path))
    print("flags: " + " ".join(link_flags()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

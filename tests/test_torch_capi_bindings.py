"""Source checks of the port's C, Fortran and Julia surface, and its C
example.

* The port's header declares the functions of the JAX package's header
  (native/include/tfqmrgpu_tpu.h) with the same arities, so that a program
  switches libraries by its -I and -l flags alone.
* Every ``bind(c, name=...)`` of the port's F90 module and every ``ccall``
  of its Julia example is exported by libtfqmrgpu_tpu_torch.so, and the
  F90 interfaces have the header's arities.
* The C sources and examples name the port's bridge and header, never the
  JAX package's.
* The C example compiles and links with gcc against the library; run
  without a card it reaches the port (its embedded interpreter imports the
  package) and exits non-zero with NO_IMPLEMENTATION; with the package off
  its path every call returns UNDOCUMENTED_ERROR.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

from tfqmrgpu_tpu_torch import native
from test_bindings_sources import _c_prototype_arity, _f90_interface_arity

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tfqmrgpu_tpu_torch"
HEADER = PORT / "capi" / "include" / "tfqmrgpu_tpu_torch.h"
F90_MODULE = PORT / "capi" / "fortran" / "tfqmrgpu.F90"
F90_EXAMPLE = PORT / "examples" / "tfqmrgpu_fortran_example.F90"
JULIA_EXAMPLE = PORT / "examples" / "tfqmrgpu_julia_example.jl"
C_EXAMPLE = PORT / "examples" / "tfqmrgpu_c_example.c"


@pytest.fixture(scope="module")
def lib():
    return native.load()


def test_header_matches_the_jax_header():
    port = _c_prototype_arity(HEADER)
    jax_side = _c_prototype_arity(REPO / "native" / "include" /
                                  "tfqmrgpu_tpu.h")
    assert len(port) == 21          # and tfqmrgpuGetErrorString
    assert port == jax_side
    decl = "const char*      tfqmrgpuGetErrorString(tfqmrgpuStatus_t status);"
    assert decl in HEADER.read_text()
    consts = re.compile(r"#define\s+(TFQMRGPU_\w+)\s+(\w+)")
    assert dict(consts.findall(HEADER.read_text())) == dict(consts.findall(
        (REPO / "native" / "include" / "tfqmrgpu_tpu.h").read_text()))


def test_library_exports_the_header(lib):
    names = set(_c_prototype_arity(HEADER)) | {"tfqmrgpuGetErrorString"}
    assert names <= set(native.SIGNATURES)
    assert all(hasattr(lib, n) for n in names)


def test_f90_module_binds_exported_symbols(lib):
    names = sorted(set(re.findall(r"bind\(c,\s*name='([A-Za-z0-9_]+)'",
                                  F90_MODULE.read_text(), re.IGNORECASE)))
    assert len(names) >= 10
    missing = [n for n in names if not hasattr(lib, n)]
    assert not missing, missing
    f_arity = _f90_interface_arity(str(F90_MODULE))
    c_arity = _c_prototype_arity(HEADER)
    assert {n: f_arity[n] for n in f_arity} == {n: c_arity[n] for n in f_arity}


def test_julia_example_calls_exported_symbols(lib):
    text = JULIA_EXAMPLE.read_text()
    names = sorted(set(re.findall(r"ccall\(\(:([A-Za-z0-9_]+)", text)))
    assert names
    assert not [n for n in names if not hasattr(lib, n)]
    assert '"libtfqmrgpu_tpu_torch.so"' in text


def test_sources_name_the_port():
    for path in sorted((PORT / "capi").rglob("*")) + sorted(
            (PORT / "examples").glob("*")):
        if path.is_dir():
            continue
        text = path.read_text()
        assert "tfqmrgpu_tpu.capi_bridge" not in text, path
        assert '"tfqmrgpu_tpu.h"' not in text, path
        assert not re.search(r"^\s*(import|from)\s+(jax|tfqmrgpu_tpu)\b",
                             text, re.MULTILINE), path
    capi = (PORT / "capi" / "src" / "capi.cpp").read_text()
    assert 'PyImport_ImportModule("tfqmrgpu_tpu_torch.capi_bridge")' in capi


def _example(tmp_path) -> str:
    exe = str(tmp_path / "c_example")
    r = subprocess.run(["gcc", "-std=c99", "-Wall", str(C_EXAMPLE),
                        *native.link_flags(), "-o", exe],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return exe


def test_c_example_without_a_card(tmp_path, lib):
    exe = _example(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(REPO)] + sys.path[1:]))
    r = subprocess.run([exe], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert "tfqmrgpu status 19: not implemented" in r.stderr, r.stderr
    assert "OK" not in r.stdout


def test_c_example_without_the_package(tmp_path, lib):
    exe = _example(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([exe], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert "cannot import tfqmrgpu_tpu_torch.capi_bridge" in r.stderr
    assert "tfqmrgpu status 14: undocumented error" in r.stderr

"""The port's public surface against the JAX package's on the CPU.

* The top level: the same public names less ``enable_x64`` (the port's
  'z' is native float64), the same ``__version__``, ``get_error_string``
  giving JAX's strings, and ``parallel``, ``profiling`` and ``ops``
  reachable after a plain import that pulls in no JAX.
* ``solve_sharded``: ``r_tile`` reaches the row tiles only, so that at
  LM < 8, where 'auto' picks the packed pairs, the layout is JAX's (host
  only: the layout is built and nothing is solved); precision 'z' and an
  unknown engine raise an error that ``except ValueError`` catches, as
  the JAX call's ``ValueError`` is.
"""

import inspect
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import make_random_problem
from test_sharded_pairs import _banded_problem
from test_torch_panel import _port
from test_torch_sharded_pairs import LAYOUT_FIELDS
import tfqmrgpu_tpu as jax_pkg
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import parallel as jparallel
from tfqmrgpu_tpu.errors import get_error_string as jax_error_string
from tfqmrgpu_tpu_torch import parallel as tparallel
from tfqmrgpu_tpu_torch.errors import (Status, TfqmrgpuError,
                                       TfqmrgpuValueError, encode_status)
from tfqmrgpu_tpu_torch.parallel import ShardedPairsLayout

# the modules the JAX package's __init__ binds by name
MODULES = ("ops", "parallel", "profiling")


def _public(pkg) -> set:
    return {n for n in dir(pkg) if not n.startswith("_")
            and not inspect.ismodule(getattr(pkg, n))}


def test_public_names_are_the_jax_packages():
    assert _public(tt) == _public(jax_pkg) - {"enable_x64"}
    assert tt.__version__ == jax_pkg.__version__ == "0.1.0"
    for name in MODULES:
        assert inspect.ismodule(getattr(tt, name))
        assert inspect.ismodule(getattr(jax_pkg, name))
    assert set(tt.__all__) == _public(tt) | set(MODULES)


@pytest.mark.parametrize("line,char", [(0, 0), (42, 0), (0, "A"),
                                       (1234, "z")])
def test_get_error_string_is_the_jax_string(line, char):
    for st in Status:
        packed = encode_status(st, line, char)
        assert tt.get_error_string(packed) == jax_error_string(packed)
    assert tt.get_error_string(999) == jax_error_string(999)


def test_plain_import_reaches_parallel_without_jax():
    code = ("import sys, tfqmrgpu_tpu_torch as t; "
            "t.parallel.solve_sharded; t.profiling.solver_roofline; "
            "t.autotune_solver; t.get_error_string(0); "
            "assert 'torch.distributed' in sys.modules; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == 'tfqmrgpu_tpu']; "
            "assert not bad, bad")
    root = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


# ---------------------------------------------------------- solve_sharded

def test_solve_sharded_r_tile_reaches_the_row_tiles_only(monkeypatch):
    """At LM 4 'auto' picks the packed pairs: with r_tile 4 the layout is
    JAX's, whose packed engine ignores r_tile (tiles of one block row)."""
    monkeypatch.setenv("TFQ_PAIRS_RESIDENT", "1")
    lm = ln = 4
    a, x, b = _banded_problem(96, 1, lm, ln)
    _, want, eng = jparallel._build_sharded(
        a, x, b, mesh=jparallel.make_mesh(2, 1), engine="auto", r_tile=4,
        interpret=True)
    assert eng == "pairs"

    class Recorder:
        def __init__(self, plan, mesh, **kw):
            self.layout = ShardedPairsLayout(plan, mesh.pr, **kw)

    monkeypatch.setattr(tparallel, "ShardedPairsSolver", Recorder)
    mesh = types.SimpleNamespace(pr=2, pc=1, device=torch.device("cpu"))
    _, sp, eng = tparallel._build_sharded(*_port(a, x, b), mesh=mesh,
                                          engine="auto", r_tile=4)
    got = sp.layout
    assert eng == "pairs" and got.r_tile == want.pp_plan.r_tile == 1
    for k in LAYOUT_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.pp_plan.ntiles == want.pp_plan.ntiles


@pytest.mark.parametrize("kw,status,what", [
    (dict(precision="z"), Status.PRECISION_MISSMATCH, "plain 'z'"),
    (dict(engine="panel"), Status.NO_IMPLEMENTATION,
     "unknown sharded engine 'panel'")])
def test_solve_sharded_refusals_are_value_errors(kw, status, what):
    a, x, b = make_random_problem(np.random.default_rng(0), mb=6, lm=4,
                                  ln=4, ncols=2, x_fill=1.0,
                                  dtype=np.complex64)
    with pytest.raises(ValueError, match=what) as err:
        tparallel.solve_sharded(*_port(a, x, b), device="cpu", **kw)
    assert isinstance(err.value, TfqmrgpuError)
    assert isinstance(err.value, TfqmrgpuValueError)
    assert err.value.code == status
    with pytest.raises(ValueError):
        jparallel.solve_sharded(a, x, b, **kw)

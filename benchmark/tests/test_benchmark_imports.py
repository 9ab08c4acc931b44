"""Nothing that the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Module names are compared whole,
by their top-level name: ``tfqmrgpu_tpu_torch`` is the port and
``tfqmrgpu_tpu`` the JAX package."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from benchmark.cells import HERE, ROOT

JAX = {"jax", "jaxlib", "flax", "tfqmrgpu_tpu"}

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from benchmark import harness
import benchmark.run
from tiny import tiny_cell
r = harness.run(tiny_cell('fd8_z.contour'), 3, 0.0, {trace}, 'cpu',
                time.perf_counter())
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import numpy as np, torch
from benchmark import problems, pool
from benchmark.reference import judge, operator, solver, tfqmr
from tiny import tiny_cell
cell = tiny_cell('fd8_z.contour')
prob = problems.build(cell.config, 2, 'cpu')
a = pool.make_pool(prob, pool.shifts(cell.points)[-1:])[0]
s = solver.ReferenceSolver(prob, a, cell.config, 'cpu', torch.complex128)
out = s.solve(1e-9, 999)
judge.read(prob, a, s.get_x(), out.iterations, 1e-9, 999, 'cpu')
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_loads_no_jax(trace):
    mods = _top_level_modules(RUN_TINY.format(
        root=str(ROOT), tests=str(HERE / "tests"), trace=trace))
    assert "tfqmrgpu_tpu_torch" in mods and "benchmark" in mods
    assert not mods & JAX, sorted(mods & JAX)


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(REFERENCE_ONLY.format(
        root=str(ROOT), tests=str(HERE / "tests")))
    assert "tfqmrgpu_tpu_torch" not in mods
    assert not mods & JAX


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_the_reference_no_program():
    for f in HERE.rglob("*.py"):
        assert not _imports(f) & JAX, f
    for f in (HERE / "reference").glob("*.py"):
        assert "tfqmrgpu_tpu_torch" not in _imports(f), f


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import run

    fake = dict(sys.modules)
    fake["tfqmrgpu_tpu_torch.solver"] = sys
    monkeypatch.setattr(sys, "modules", fake)
    assert run.loaded_forbidden() == []
    fake["tfqmrgpu_tpu.ops"] = sys
    fake["jaxlib"] = sys
    assert run.loaded_forbidden() == ["jaxlib", "tfqmrgpu_tpu"]

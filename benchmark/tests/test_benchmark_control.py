"""The judge at a size that a CPU test can hold: the port's run is
correct; the control (the reference in complex64 in the program's place)
and each fault that a solve can have, planted under the timed path, come
out as not correct.  The harness runs as on the card but for its look for
one (device "cpu")."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.solver import ReferenceSolver

from tiny import cell_names, tiny_cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, seed=7, make_solver=None):
    return harness.run(tiny_cell(name), seed, 0.0, False, "cpu",
                       time.perf_counter(), make_solver=make_solver)


@pytest.mark.parametrize("name", cell_names())
def test_the_port_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == tiny_cell(
        name).points["count"]
    assert len(r["readings"]) == r["attempted"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", cell_names())
def test_the_control_is_not_correct(name):
    r = _run(name, make_solver=lambda *a: ReferenceSolver(
        *a, dtype=torch.complex64))
    assert not r["correct"]
    c = r["checks"]
    assert any(c[k]["value"] > c[k]["limit"] for k in
               ("resid", "xdev", "iter_gap", "failed")), c


def _port_with(monkeypatch, get_x=None, step=None):
    import tfqmrgpu_tpu_torch.core as core
    from benchmark import program

    if step is not None:
        monkeypatch.setattr(core, "step", step)
    if get_x is not None:
        plain = program.PortSolver.get_x
        monkeypatch.setattr(program.PortSolver, "get_x",
                            lambda self: get_x(plain(self)))


@pytest.mark.parametrize("name", cell_names())
def test_a_step_that_returns_its_state_unchanged(monkeypatch, name):
    _port_with(monkeypatch, step=lambda prim, c, v3, dt:
               dataclasses.replace(c, it=c.it + 1))
    r = _run(name)
    assert not r["correct"] and r["checks"]["resid"]["value"] >= 0.99


@pytest.mark.parametrize("name", cell_names())
def test_half_the_right_hand_sides_left_out(monkeypatch, name):
    def drop_half(x):
        x = x.copy()
        x[..., x.shape[-1] // 2:] = 0
        return x

    _port_with(monkeypatch, get_x=drop_half)
    r = _run(name)
    assert not r["correct"] and r["checks"]["resid"]["value"] >= 0.5


@pytest.mark.parametrize("size", [1e-3, 1e-6])
@pytest.mark.parametrize("name", cell_names())
def test_an_answer_altered_where_it_is_produced(monkeypatch, name, size):
    def alter(x):
        x = x.copy()
        i = np.unravel_index(np.abs(x).argmax(), x.shape)
        x[i] *= 1 + size
        return x

    _port_with(monkeypatch, get_x=alter)
    r = _run(name)
    assert not r["correct"], r["checks"]

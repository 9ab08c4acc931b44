"""The port's problem files (``tfqmrgpu_tpu_torch/io``) and the generator's
XML export against the JAX package's: the writers give the same bytes,
each package reads the other's files into identical arrays, the pair-plan
reader gives the same tables, and ``generator.main`` writes the same
``FD_example.xml``."""

import types

import numpy as np
import pytest

from tfqmrgpu_tpu_torch import generator as tgen
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.io import legacy as tlegacy
from tfqmrgpu_tpu_torch.io import planfile as tplanfile
from tfqmrgpu_tpu_torch.io import xmlio as txml
from conftest import make_random_problem
from tfqmrgpu_tpu import generator as jgen
from tfqmrgpu_tpu.bsr import Bsr as JBsr
from tfqmrgpu_tpu.io import legacy as jlegacy
from tfqmrgpu_tpu.io import planfile as jplanfile
from tfqmrgpu_tpu.io import xmlio as jxml
from tfqmrgpu_tpu.plan import create_plan as jcreate_plan


def _as(cls, m):
    return cls(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)


def _random_xml_problem(cls, seed):
    """A random real problem in the writer's form: every A block its own
    stencil entry, one B block per column, X with a reference."""
    a, x, b = make_random_problem(np.random.default_rng(seed), mb=7, lm=4,
                                  ln=4, ncols=3, x_fill=0.6)
    rng = np.random.default_rng(seed + 100)
    return types.SimpleNamespace(
        a=_as(cls, a), b=_as(cls, b), x=_as(cls, x),
        a_stencil=rng.standard_normal((a.nnzb, 4, 4)),
        a_indirection=np.arange(a.nnzb, dtype=np.uint32), a_scale=0.125,
        b_blocks=a.data.real[:1], b_indirection=np.zeros(b.nnzb, np.uint32),
        x_reference=rng.standard_normal((x.nnzb, 4, 4)).astype(np.float32),
        tolerance=1e-9,
        params=dict(rsb=1.75, rtb=2.5, block_edge=2, dimension=3, energy=0.0,
                    nfd=4, bs=8))


def _problems(which, cls):
    if which == "fd":
        gen = tgen if cls is TBsr else jgen
        return gen.generate_fd_problem(rtb=6.75, reference=True)
    return _random_xml_problem(cls, 9)


def _assert_same_operators(p, q):
    for name in ("a", "b", "x"):
        u, v = getattr(p, name), getattr(q, name)
        assert (u.nrows, u.ncols, u.name) == (v.nrows, v.ncols, v.name)
        assert np.array_equal(u.rowptr, v.rowptr)
        assert np.array_equal(u.colind, v.colind)
        assert (u.data is None) == (v.data is None)
        if u.data is not None:
            assert u.data.dtype == v.data.dtype
            assert np.array_equal(u.data, v.data)
    assert p.tolerance == q.tolerance


@pytest.mark.parametrize("which", ["fd", "random"])
def test_xml_files_identical(tmp_path, which):
    tpath, jpath = tmp_path / "port.xml", tmp_path / "jax.xml"
    txml.write_xml(_problems(which, TBsr), str(tpath))
    jxml.write_xml(_problems(which, JBsr), str(jpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    for path in (tpath, jpath):
        tp, jp = txml.read_xml(str(path)), jxml.read_xml(str(path))
        assert isinstance(tp.a, TBsr)
        _assert_same_operators(tp, jp)
        assert tp.x_has_reference == jp.x_has_reference is True


@pytest.mark.parametrize("which", ["fd", "random"])
def test_legacy_files_identical(tmp_path, which):
    if which == "fd":
        ops = _problems("fd", TBsr)
        a, b = ops.a_with_data(), ops.b_with_data()
        x = ops.x_with_reference()
    else:
        a, x, b = make_random_problem(np.random.default_rng(4), mb=8, lm=4,
                                      ln=8, ncols=3)
        x = x.with_data(np.random.default_rng(5).standard_normal(
            (x.nnzb, 4, 8)) + 0.5j)
    tpath, jpath = tmp_path / "port.txt", tmp_path / "jax.txt"
    tlegacy.write_legacy(str(tpath), *(_as(TBsr, m) for m in (a, b, x)),
                         tolerance=1e-9)
    jlegacy.write_legacy(str(jpath), *(_as(JBsr, m) for m in (a, b, x)),
                         tolerance=1e-9)
    assert tpath.read_bytes() == jpath.read_bytes()
    for path in (tpath, jpath):
        _assert_same_operators(tlegacy.read_legacy(str(path)),
                               jlegacy.read_legacy(str(path)))


def test_plan_file_tables_identical(tmp_path):
    a, x, b = make_random_problem(np.random.default_rng(6), mb=9, lm=4,
                                  ln=4, ncols=3)
    jp = jcreate_plan(a, x, b, cache=False)
    # one line per pair: iY iA iX beta (beta 0 opens a Y block); the Y
    # blocks are listed out of order, as the golden unordered plans are
    starts = jp.starts.astype(np.int64)
    order = np.random.default_rng(7).permutation(jp.nnzb_x)
    lines = [f"#nnzb_for_Y_A_X= {jp.nnzb_x} {jp.nnzb_a} {jp.nnzb_x}"]
    for iy in order:
        for k, p in enumerate(range(starts[iy], starts[iy + 1])):
            lines.append(f"{iy} {jp.pairs[p, 0]} {jp.pairs[p, 1]} "
                         f"{int(k > 0)}")
    path = tmp_path / "plan.txt"
    path.write_text("\n".join(lines) + "\n")
    tf = tplanfile.read_plan_file(str(path))
    jf = jplanfile.read_plan_file(str(path))
    for k in ("nnzb_y", "nnzb_a", "nnzb_x"):
        assert getattr(tf, k) == getattr(jf, k)
    for k in ("starts", "pairs", "y_order"):
        assert getattr(tf, k).dtype == getattr(jf, k).dtype
        assert np.array_equal(getattr(tf, k), getattr(jf, k))
    assert np.array_equal(tf.y_order, order)


def test_generator_main_writes_the_same_file(tmp_path, monkeypatch):
    args = ["1.75", "4.75", "2", "3", "0.25", "y", "0"]
    files = {}
    for name, main in (("port", tgen.main), ("jax", jgen.main)):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert main(list(args)) == 0
        files[name] = (cwd / "FD_example.xml").read_bytes()
    assert files["port"] == files["jax"]
    assert b'tolerance="' in files["port"] and b'id="X"' in files["port"]

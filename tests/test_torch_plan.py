"""The PyTorch port's analysis step against the JAX package's: identical
tables, identical error codes."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_random_problem
from tfqmrgpu_tpu import plan as jplan_mod
from tfqmrgpu_tpu_torch import convert
from tfqmrgpu_tpu_torch import plan as tplan_mod
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.errors import Status as TStatus
from tfqmrgpu_tpu_torch.errors import TfqmrgpuError as TError
from tfqmrgpu_tpu.errors import TfqmrgpuError as JError

torch.set_num_threads(2)

TABLES = ("starts", "pairs", "subset", "colindx")
HOST_TABLES = ("rowptr_a", "colind_a", "rowptr_x")


def _port_bsrs(*bsrs):
    return [TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
            for m in bsrs]


def _assert_tables_equal(tp, jp):
    for k in TABLES:
        got = getattr(tp, k).cpu().numpy()
        want = np.asarray(getattr(jp, k))
        assert got.dtype == np.int32
        assert got.shape == want.shape, k
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), k
    for k in HOST_TABLES:                       # numpy int64 on the host
        got = getattr(tp, k)
        assert isinstance(got, np.ndarray) and got.dtype == np.int64, k
        assert np.array_equal(got, np.asarray(getattr(jp, k), np.int64)), k
    for k in ("nrows", "ncols", "nnzb_a", "nnzb_x", "nnzb_b"):
        assert getattr(tp, k) == getattr(jp, k), k


@pytest.mark.parametrize("seed,mb,lm,ln,ncols,x_fill", [
    (0, 12, 4, 8, 3, 0.6),
    (1, 16, 8, 8, 4, 0.4),
    (2, 9, 4, 5, 2, 1.0),
    (3, 16, 8, 10, 5, 0.3),
])
def test_plan_tables_identical(seed, mb, lm, ln, ncols, x_fill):
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                                  x_fill=x_fill)
    jp = jplan_mod.create_plan(a, x, b, cache=False)
    tp = tplan_mod.create_plan(*_port_bsrs(a, x, b), device="cpu")
    _assert_tables_equal(tp, jp)


def test_plan_index_offset_and_fd_identical():
    from tfqmrgpu_tpu.generator import generate_fd_problem

    prob = generate_fd_problem(rtb=4.75)
    jp = jplan_mod.create_plan(prob.a, prob.x, prob.b, cache=False)
    tp = tplan_mod.create_plan(*_port_bsrs(prob.a, prob.x, prob.b),
                               device="cpu")
    _assert_tables_equal(tp, jp)
    # Fortran-style indices give the same tables
    shifted = []
    for m in (prob.a, prob.x, prob.b):
        shifted.append(TBsr(m.nrows, m.ncols, m.rowptr + 1, m.colind + 1,
                            None, m.name))
    _assert_tables_equal(tplan_mod.create_plan(*shifted, index_offset=1,
                                               device="cpu"), jp)


def test_fd_generator_identical():
    """The port's FD problem is the JAX package's: same patterns, same A
    and B data, same dense reference solution."""
    from tfqmrgpu_tpu.generator import generate_fd_problem as jgen
    from tfqmrgpu_tpu_torch.generator import generate_fd_problem as tgen

    jprob = jgen(rtb=4.75, reference=True)
    tprob = tgen(rtb=4.75, reference=True)
    for k in ("a", "x", "b"):
        jm, tm = getattr(jprob, k), getattr(tprob, k)
        assert (tm.nrows, tm.ncols) == (jm.nrows, jm.ncols), k
        assert np.array_equal(tm.rowptr, jm.rowptr), k
        assert np.array_equal(tm.colind, jm.colind), k
    assert np.array_equal(tprob.a_with_data().data, jprob.a_with_data().data)
    assert np.array_equal(tprob.b_with_data().data, jprob.b_with_data().data)
    assert tprob.tolerance == jprob.tolerance
    assert jprob.x_reference is not None
    assert tprob.x_reference.dtype == jprob.x_reference.dtype
    scale = np.max(np.abs(jprob.x_reference))
    assert np.max(np.abs(tprob.x_reference.astype(np.float64)
                         - jprob.x_reference)) <= 1e-6 * scale


def test_b_not_subset_of_x_same_code():
    rng = np.random.default_rng(5)
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2, x_fill=0.3)
    # put a B block in a row where X has no block of that column
    row_of_x = x.row_of()
    rows_with_col0 = set(row_of_x[x.colind == 0].tolist())
    bad_row = min(set(range(8)) - rows_with_col0)
    rows = [[] for _ in range(8)]
    for r, c in zip(b.row_of(), b.colind):
        rows[int(r)].append(int(c))
    rows[bad_row] = sorted(set(rows[bad_row]) | {0})
    rowptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    colind = np.array([c for r in rows for c in r])
    from tfqmrgpu_tpu.bsr import Bsr as JBsr

    b_bad = JBsr(8, 2, rowptr, colind, None, name="B")
    with pytest.raises(JError) as je:
        jplan_mod.create_plan(a, x, b_bad, cache=False)
    with pytest.raises(TError) as te:
        tplan_mod.create_plan(*_port_bsrs(a, x, b_bad), device="cpu")
    assert te.value.status == je.value.status
    assert te.value.code == TStatus.B_IS_NOT_SUBSET_OF_X


def test_plan_from_numpy_matches_create_plan():
    rng = np.random.default_rng(7)
    a, x, b = make_random_problem(rng, mb=10, lm=4, ln=4, ncols=3)
    jp = jplan_mod.create_plan(a, x, b, cache=False)
    tp = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    _assert_tables_equal(tp, jp)
    with pytest.raises(TError):
        convert.plan_from_numpy(
            **{k: getattr(jp, k) for k in convert.PLAN_FIELDS if k != "ncols"},
            ncols=0, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, tfqmrgpu_tpu_torch, tfqmrgpu_tpu_torch.convert, "
            "tfqmrgpu_tpu_torch.generator, tfqmrgpu_tpu_torch.refine, "
            "tfqmrgpu_tpu_torch.bench, tfqmrgpu_tpu_torch.io.xmlio, "
            "tfqmrgpu_tpu_torch.io.legacy, tfqmrgpu_tpu_torch.io.planfile, "
            "tfqmrgpu_tpu_torch.api, tfqmrgpu_tpu_torch.capi_bridge, "
            "tfqmrgpu_tpu_torch.native; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('tfqmrgpu_tpu.') or m == 'tfqmrgpu_tpu']; "
            "assert not bad, bad")
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)

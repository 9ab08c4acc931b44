"""The port's ``recover_grid`` / ``PairGrid`` (ops/pallas_spmm.py) against
the JAX package's on the cases of tests/test_recover_grid.py: every table
bit-identical, and the grid factorization's multiply equal to the pair
list's."""

import numpy as np
import pytest

from test_recover_grid import _banded_pairs, _grid_multiply
from tfqmrgpu_tpu.ops import pallas_spmm as jrt
from tfqmrgpu_tpu_torch.ops import pallas_spmm as trt

CASES = {"banded": dict(), "unused_a_ids": dict(mb=12, ncols=2, deg=3),
         "wide": dict(mb=17, ncols=5, deg=4)}


def _pairs(name):
    pa, px, py, nnzb, nnzb_a = _banded_pairs(**CASES[name])
    if name == "unused_a_ids":
        pa = pa + 5                   # ids 0..4 unused, the max id shifts
        nnzb_a += 5
    return pa, px, py, nnzb, nnzb_a


@pytest.mark.parametrize("name", sorted(CASES))
def test_recover_grid_tables_identical(name):
    pa, px, py, nnzb, _ = _pairs(name)
    got = trt.recover_grid(pa, px, py, nnzb)
    want = jrt.recover_grid(pa, px, py, nnzb)
    assert got._fields == want._fields
    for k in want._fields:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert type(g) is type(w) and g == w, k


@pytest.mark.parametrize("name", sorted(CASES))
def test_recover_grid_multiply(name):
    pa, px, py, nnzb, nnzb_a = _pairs(name)
    g = trt.recover_grid(pa, px, py, nnzb)
    assert g.nslots * g.ncols == nnzb             # grid-dense: full rows
    if name == "unused_a_ids":
        assert g.a_order.min() >= 5
    assert np.unique(g.a_order).size == g.a_order.size
    rng = np.random.default_rng(nnzb)
    a = rng.standard_normal((nnzb_a, 2, 2))
    x = rng.standard_normal((nnzb, 2, 2))
    want = np.zeros((nnzb, 2, 2))
    np.add.at(want, py, np.matmul(a[pa], x[px]))
    np.testing.assert_allclose(_grid_multiply(g, a, x, 2, 2, nnzb), want,
                               atol=1e-12)

"""The port's vector ops and scalar decisions against the JAX package's, on
the same random float64 inputs: values to 1e-14 relative, status codes
exactly (including forced breakdowns)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfqmrgpu_tpu.ops import decisions as jdec
from tfqmrgpu_tpu.ops import linalg as jlin
from tfqmrgpu_tpu_torch.ops import decisions as tdec
from tfqmrgpu_tpu_torch.ops import linalg as tlin

torch.set_num_threads(2)

RTOL = 1e-14   # float64 round-off of sums and products in another order


def _close(got, want, scale=None):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.max(np.abs(want)) if scale is None else scale
    assert np.max(np.abs(got - want), initial=0.0) <= RTOL * max(scale, 1e-300)


def _planes(rng, shape, dtype=np.float64):
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _t(pair):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in pair)


def _j(pair):
    return tuple(jnp.asarray(p) for p in pair)


@pytest.fixture
def vec_case():
    rng = np.random.default_rng(11)
    nnzb, lm, ln, ncols = 37, 4, 8, 5
    colindx = rng.integers(0, ncols, size=nnzb)
    colindx[:ncols] = np.arange(ncols)          # no empty column
    return rng, nnzb, lm, ln, ncols, colindx.astype(np.int32)


@pytest.mark.parametrize("shadow_f32", [False, True])
def test_dotp_nrm2_match(vec_case, shadow_f32):
    rng, nnzb, lm, ln, ncols, colindx = vec_case
    x = _planes(rng, (nnzb, lm, ln), np.float32 if shadow_f32 else np.float64)
    y = _planes(rng, (nnzb, lm, ln))
    cols = tlin.columns(torch.from_numpy(colindx), ncols)
    jr, ji = jlin.dotp(_j(x), _j(y), jnp.asarray(colindx), ncols)
    tr, ti = tlin.dotp(_t(x), _t(y), cols)
    assert tr.dtype == torch.float64
    # scale: the column sums of |x| |y|, which bound the round-off
    mag = np.zeros((ncols, ln))
    np.add.at(mag, colindx, (np.abs(x[0]) + np.abs(x[1])).astype(np.float64)
              .__mul__(np.abs(y[0]) + np.abs(y[1])).sum(axis=1))
    _close(tr, jr, mag.max())
    _close(ti, ji, mag.max())
    _close(tlin.nrm2(_t(y), cols), jlin.nrm2(_j(y), jnp.asarray(colindx), ncols))


def test_reductions_are_deterministic(vec_case):
    rng, nnzb, lm, ln, ncols, colindx = vec_case
    y = _t(_planes(rng, (nnzb, lm, ln)))
    cols = tlin.columns(torch.from_numpy(colindx), ncols)
    first = tlin.nrm2(y, cols)
    for _ in range(3):
        assert torch.equal(tlin.nrm2(y, cols), first)


def test_axpy_xpay_add_rhs_unit_match(vec_case):
    rng, nnzb, lm, ln, ncols, colindx = vec_case
    x = _planes(rng, (nnzb, lm, ln))
    y = _planes(rng, (nnzb, lm, ln))
    a = _planes(rng, (ncols, ln))
    ci = torch.from_numpy(colindx)
    for got, want in (
            (tlin.axpy(_t(y), _t(x), _t(a), ci),
             jlin.axpy(_j(y), _j(x), _j(a), jnp.asarray(colindx))),
            (tlin.xpay(_t(y), _t(a), _t(x), ci),
             jlin.xpay(_j(y), _j(a), _j(x), jnp.asarray(colindx)))):
        _close(got[0], want[0])
        _close(got[1], want[1])
    subset = rng.permutation(nnzb)[:9].astype(np.int32)
    b = _planes(rng, (9, lm, ln))
    got = tlin.add_rhs(_t(y), _t(b), -1.0, torch.from_numpy(subset))
    want = jlin.add_rhs(_j(y), _j(b), -1.0, jnp.asarray(subset))
    _close(got[0], want[0])
    _close(got[1], want[1])
    for lm_, ln_ in ((4, 8), (8, 10), (4, 4)):
        got = tlin.set_unit_blocks(3, lm_, ln_, torch.float64)
        want = jlin.set_unit_blocks(3, lm_, ln_, jnp.float64)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def _scalar_case(rng, shape=(4, 8)):
    def pair():
        return _planes(rng, shape)

    status = np.zeros(shape, np.int32)
    status[0, 0] = 1
    status[0, 1] = -3
    return status, pair, rng.random(shape) + 0.1


def test_decisions_match_with_breakdowns():
    rng = np.random.default_rng(3)
    status, pair, pos = _scalar_case(rng)
    rho, z35, eta, z34, alfa = pair(), pair(), pair(), pair(), pair()
    var, tau, d55 = pos, pos * 2.0, pos * 0.5
    # forced breakdowns, one kind per row slot
    rho[0][1, :2] = 0.0
    rho[1][1, :2] = 0.0                          # |rho|^2 == 0 -> dec35, dec34
    z35[0][2, 0] = z35[1][2, 0] = 0.0            # |z35|^2 == 0 -> dec35
    z34[0][2, 3] = z34[1][2, 3] = 1e-160         # |z34|^2 < EPSILON -> dec34
    z35[0][3, 1] = np.inf                        # non-finite -> dec35
    var = var.copy()
    var[3, 2] = np.nan                           # non-finite var -> dec34
    tau = tau.copy()
    tau[1, 5] = 0.0                              # tau == 0 -> decT
    d55 = d55.copy()
    d55[2, 6] = np.inf                           # non-finite d55 -> decT
    f64 = jnp.float64

    js, jrho, jbeta = jdec.dec35(jnp.asarray(status), _j(rho), _j(z35), f64)
    ts, trho, tbeta = tdec.dec35(torch.from_numpy(status), _t(rho), _t(z35),
                                 torch.float64)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy() == -1).sum() >= 3
    for got, want in zip(trho + tbeta, jrho + jbeta):
        _close(got, want)

    js, jc67, jalfa = jdec.dec34(js, jrho, _j(eta), _j(z34), jnp.asarray(var), f64)
    ts, tc67, talfa = tdec.dec34(ts, trho, _t(eta), _t(z34),
                                 torch.from_numpy(var), torch.float64)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy() == -2).sum() >= 2
    for got, want in zip(tc67 + talfa, jc67 + jalfa):
        _close(got, want)

    for with_c67 in (True, False):
        jout = jdec.dect(js, jnp.asarray(var), jnp.asarray(tau), jalfa,
                         jnp.asarray(d55), f64, with_c67=with_c67)
        tout = tdec.dect(ts, torch.from_numpy(var), torch.from_numpy(tau),
                         talfa, torch.from_numpy(d55), torch.float64,
                         with_c67=with_c67)
        assert np.array_equal(tout[0].numpy(), np.asarray(jout[0]))
        assert (tout[0].numpy() == -3).sum() >= 3
        if with_c67:
            _close(tout[1][0], jout[1][0])
            _close(tout[1][1], jout[1][1])
        else:
            assert tout[1] is None and jout[1] is None
        for got, want in zip(tout[2] + tout[3:], jout[2] + jout[3:]):
            _close(got, want)


def test_epsilon_is_the_references():
    assert tdec.EPSILON == jdec.EPSILON == 2.5e-308


# ---------------------------------------- VectorPasses' plain versions

def _ragged_case(dtype, lm, ln):
    """Blocks of six columns with ragged widths (1, 40, 7, 0, 90, 3): an
    empty column, and one wider than ``SUM_CHUNKS`` runs of one slot."""
    rng = np.random.default_rng(lm * 100 + ln)
    colindx = np.repeat(np.arange(6), (1, 40, 7, 0, 90, 3))
    rng.shuffle(colindx)
    nnzb, ncols = colindx.shape[0], 6
    npdt = np.float32 if dtype == torch.float32 else np.float64
    cols = tlin.columns(torch.from_numpy(colindx.astype(np.int32)), ncols)
    subset = torch.from_numpy(rng.permutation(nnzb)[:30].astype(np.int32))
    return rng, cols, subset, nnzb, ncols, npdt


VECTOR_CASES = [(dt, lm, ln) for dt in (torch.float64, torch.float32)
                for lm, ln in ((8, 8), (4, 16), (16, 4))]


@pytest.mark.parametrize("dtype,lm,ln", VECTOR_CASES)
def test_vector_passes_plain_elementwise_is_linalg_in_place(dtype, lm, ln):
    """``VectorPasses.axpy`` / ``xpay`` / ``add_rhs`` on the CPU (their
    plain versions) give ``linalg.axpy`` / ``xpay`` / ``add_rhs``'s bits,
    written into the first vector's planes; the other operands stay."""
    rng, cols, subset, nnzb, ncols, npdt = _ragged_case(dtype, lm, ln)
    vp = tlin.VectorPasses(cols, subset)
    x = _t(_planes(rng, (nnzb, lm, ln), npdt))
    y = _t(_planes(rng, (nnzb, lm, ln), npdt))
    a = _t(_planes(rng, (ncols, ln)))              # float64, as decisions
    b = _t(_planes(rng, (30, lm, ln), npdt))
    keep = [t.clone() for t in x + b]
    cases = [(vp.axpy, (x, a), tlin.axpy(y, x, a, cols.colindx)),
             (vp.xpay, (a, x), tlin.xpay(y, a, x, cols.colindx))]
    cases += [(vp.add_rhs, (b, s), tlin.add_rhs(y, b, s, subset))
              for s in (1.0, -1.0, 0.5)]
    for fn, args, want in cases:
        mine = tuple(t.clone() for t in y)
        got = fn(mine, *args)
        assert got is mine
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(t, k) for t, k in zip(x + b, keep))


def _sum_tolerance(cols, lm, dtype) -> float:
    """The stated tolerance of the kernels' column sums against ``dotp`` /
    ``nrm2``: 4 (width + LM) eps of the data type, relative to the column
    sums of |x| |y| (the sums' order differs; each stage's round-off is
    bounded by its terms' count times eps)."""
    return 4 * (cols.table.shape[1] + lm) * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype,lm,ln", VECTOR_CASES)
def test_vector_passes_plain_sums_match_linalg(dtype, lm, ln):
    """The plain two-stage ``dotp`` (v3 float32 or the data type against the
    data) and ``nrm2`` within the stated tolerance of ``linalg``'s, an
    empty column exactly 0, and the same bits on every call."""
    rng, cols, subset, nnzb, ncols, npdt = _ragged_case(dtype, lm, ln)
    vp = tlin.VectorPasses(cols, subset)
    y = _t(_planes(rng, (nnzb, lm, ln), npdt))
    tol = _sum_tolerance(cols, lm, dtype)
    ci = cols.colindx.numpy()

    def mag(u, w):
        m = np.zeros((ncols, ln))
        np.add.at(m, ci, ((u[0].abs() + u[1].abs()).double()
                          * (w[0].abs() + w[1].abs()).double()).sum(1).numpy())
        return m

    for xdt in (torch.float32, dtype):
        x = tuple(t.to(xdt) for t in _t(_planes(rng, (nnzb, lm, ln))))
        got, want = vp.dotp(x, y), tlin.dotp(x, y, cols)
        scale = mag(x, y)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and g.shape == (ncols, ln)
            assert (np.abs((g - w).numpy()) <= tol * scale).all()
            assert (g[3] == 0).all()
        again = vp.dotp(x, y)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    got, want = vp.nrm2(y), tlin.nrm2(y, cols)
    assert (np.abs((got - want).numpy()) <= tol * want.numpy()).all()
    assert torch.equal(vp.nrm2(y), got)


@pytest.mark.parametrize("width", [5, 64, 150])
def test_vector_passes_column_sums_keep_their_order(width):
    """``plain_column_sums`` adds in the order the kernel does: each of
    ``SUM_CHUNKS`` runs of the table's slots in order from 0, then the
    pairwise tree; checked to the bit against that order in Python floats
    on partials whose sum depends on the order."""
    rng = np.random.default_rng(width)
    colindx = np.zeros(width, np.int32)
    cols = tlin.columns(torch.from_numpy(colindx), 1)
    vp = tlin.VectorPasses(cols, torch.zeros(1, dtype=torch.int32))
    part = rng.standard_normal((1, width, 3)) * 10.0 ** rng.integers(
        -8, 8, (1, width, 3))
    got = vp.plain_column_sums(torch.from_numpy(part))
    table = cols.table[0].tolist()
    k = -(-width // tlin.SUM_CHUNKS)
    for lane in range(3):
        runs = []
        for r in range(tlin.SUM_CHUNKS):
            s = 0.0
            for j in table[r * k:(r + 1) * k]:
                s += float(part[0, j, lane])
            runs.append(s)
        while len(runs) > 1:
            h = len(runs) // 2
            runs = [runs[i] + runs[i + h] for i in range(h)]
        assert float(got[0, 0, lane]) == runs[0]


def test_vector_passes_on_the_cpu_launch_nothing(monkeypatch):
    """On CPU tensors every ``VectorPasses`` method takes its plain
    version: no kernel is built or launched."""
    from tfqmrgpu_tpu_torch import _build

    def refuse():
        raise AssertionError("a CPU tensor must not reach a kernel")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    rng, cols, subset, nnzb, ncols, npdt = _ragged_case(torch.float64, 4, 8)
    vp = tlin.VectorPasses(cols, subset)
    x = _t(_planes(rng, (nnzb, 4, 8)))
    y = _t(_planes(rng, (nnzb, 4, 8)))
    a = _t(_planes(rng, (ncols, 8)))
    vp.axpy(y, x, a)
    vp.xpay(y, a, x)
    vp.add_rhs(y, _t(_planes(rng, (30, 4, 8))), -1.0)
    vp.dotp(x, y)
    vp.nrm2(y)

"""The port's block-sparse product (plain version and the pair-plan kernel
wrapper) against the JAX package's: its f64 pair-list product to 1e-12,
and the TPU kernel K1 itself, run in interpret mode in f32, to 1e-4 (the
reference's float gate, bench_tfqmrgpu.cu:414).  The kernel itself is
tested on the card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_problem
from tfqmrgpu_tpu.ops import blocksparse as jbs
from tfqmrgpu_tpu_torch import TfqmrgpuError, create_plan
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.ops import blocksparse as tbs
from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

torch.set_num_threads(2)


def _maxdev(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _problem(seed, mb, lm, ln, ncols, x_fill=0.6):
    rng = np.random.default_rng(seed)
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                                  x_fill=x_fill)
    plan = create_plan(*[TBsr(m.nrows, m.ncols, m.rowptr, m.colind, None,
                              m.name) for m in (a, x, b)], device="cpu")
    xv = (rng.standard_normal((plan.nnzb_x, lm, ln))
          + 1j * rng.standard_normal((plan.nnzb_x, lm, ln)))
    return plan, a.data, xv


def _planes(c, dtype=torch.float64):
    return (torch.from_numpy(np.ascontiguousarray(c.real)).to(dtype),
            torch.from_numpy(np.ascontiguousarray(c.imag)).to(dtype))


@pytest.mark.parametrize("seed,mb,lm,ln,ncols", [
    (0, 12, 4, 8, 3), (1, 16, 8, 8, 2), (2, 10, 8, 10, 3), (3, 9, 4, 5, 4),
])
def test_spmm_matches_jax_pairs_f64(seed, mb, lm, ln, ncols):
    plan, a, xv = _problem(seed, mb, lm, ln, ncols)
    pa = plan.pairs[:, 0].numpy()
    px = plan.pairs[:, 1].numpy()
    py = plan.pair_y().numpy().astype(np.int32)
    jr, ji = jbs.spmm_pairs((jnp.asarray(a.real), jnp.asarray(a.imag)),
                            (jnp.asarray(xv.real), jnp.asarray(xv.imag)),
                            jnp.asarray(pa), jnp.asarray(px), jnp.asarray(py),
                            plan.nnzb_x)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    mult = PairPlanMultiply(plan, *_planes(a), ln)
    for yr, yi in (mult(_planes(xv)), tbs.spmm_pairs(
            _planes(a), _planes(xv), plan.pairs[:, 0], plan.pairs[:, 1],
            plan.pair_y(), plan.nnzb_x)):
        assert yr.dtype == torch.float64
        assert _maxdev(yr.numpy() + 1j * yi.numpy(), want) <= 1e-12
    assert PairPlanMultiply.launches == 0          # the CPU never launches


def _banded(mb, ncols, lm, ln, seed):
    """A banded A (stencil 0, 1, 2), X full over ncols columns, B on the
    diagonal: the pattern class the TPU kernel's packer recovers."""
    rng = np.random.default_rng(seed)
    cols_a = [sorted({(i + s) % mb for s in (0, 1, 2)}) for i in range(mb)]
    rowptr_a = np.concatenate([[0], np.cumsum([len(c) for c in cols_a])])
    a = TBsr(mb, mb, rowptr_a, np.concatenate(cols_a), None, "A")
    x = TBsr(mb, ncols, np.arange(mb + 1) * ncols,
             np.tile(np.arange(ncols), mb), None, "X")
    brows = [[j for j in range(ncols) if j == i] for i in range(mb)]
    rowptr_b = np.concatenate([[0], np.cumsum([len(r) for r in brows])])
    b = TBsr(mb, ncols, rowptr_b, np.concatenate(brows).astype(int), None, "B")
    plan = create_plan(a, x, b, device="cpu")
    av = (rng.standard_normal((a.nnzb, lm, lm))
          + 1j * rng.standard_normal((a.nnzb, lm, lm)))
    xv = (rng.standard_normal((x.nnzb, lm, ln))
          + 1j * rng.standard_normal((x.nnzb, lm, ln)))
    return plan, x.row_of(), av, xv


def test_spmm_matches_tpu_kernel_interpret_f32():
    from tfqmrgpu_tpu.ops import pairpanel as jpp

    lm = ln = 4
    plan, row_of_x, av, xv = _banded(mb=10, ncols=2, lm=lm, ln=ln, seed=4)
    pa = plan.pairs[:, 0].numpy()
    px = plan.pairs[:, 1].numpy()
    py = plan.pair_y().numpy()
    pplan = jpp.pack_pair_plan(pa, px, py, plan.nnzb_x, plan.nnzb_x, lm, ln,
                               r_tile=1, row_of=row_of_x,
                               col_of=plan.colindx.numpy())
    f32 = np.float32
    panels = jnp.asarray(jpp.build_a_panels(pplan, av.real.astype(f32),
                                            av.imag.astype(f32)))
    k1 = jpp.make_pairpanel_multiply(pplan, panels, precision="highest",
                                     interpret=True)
    xf = jnp.asarray(jpp.permute_x(pplan, xv.real.astype(f32),
                                   xv.imag.astype(f32)))
    yre, yim = jpp.unpermute_y(pplan, np.asarray(k1(xf)))
    want = yre + 1j * yim
    mult = PairPlanMultiply(plan, *_planes(av, torch.float32), ln)
    yr, yi = mult(_planes(xv, torch.float32))
    assert _maxdev(yr.numpy() + 1j * yi.numpy(), want) <= 1e-4


def test_wrapper_rejects_bad_inputs():
    plan, a, xv = _problem(5, 8, 4, 8, 2)
    mult = PairPlanMultiply(plan, *_planes(a), 8)
    good = _planes(xv)
    with pytest.raises(ValueError):
        mult((good[0].to(torch.float32), good[1].to(torch.float32)))
    with pytest.raises(ValueError):
        mult((good[0][:-1], good[1][:-1]))
    with pytest.raises(ValueError):                 # not contiguous
        mult((good[0].transpose(1, 2).contiguous().transpose(1, 2),
              good[1]))
    with pytest.raises(ValueError):                 # A of the wrong shape
        PairPlanMultiply(plan, *_planes(a[:-1]), 8)
    with pytest.raises(TfqmrgpuError):              # no kernel for this dtype
        PairPlanMultiply(plan, *_planes(a, torch.float16), 8)

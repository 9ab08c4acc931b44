"""The solver object and the one-call API.

The reference's C workflow (createHandle -> createPlan -> bufferSize ->
setBuffer -> setMatrix('A'/'B') -> solve -> getInfo -> getMatrix('X'),
tfqmrgpu.cu:700-791) reduces to a ``Solver``: the plan, the matrices on
one device, and the solve.  PyTorch's caching allocator owns the buffers.

Engines (``ENGINES``), as in the JAX package:

* ``'dense'``  -- panel engine, A densified into [NR, NR] planes; the
  multiply is four ``torch.matmul`` calls (``ops/panel.py``), native
  float64 for 'z', full float32 for 'c'.
* ``'pallas'`` -- panel engine over row-tile union panels of A
  (``ops/pallas_spmm.py``): the hand-written Hopper kernel
  ``csrc/rowtile_spmm.cu`` on a CUDA device, its plain version on the CPU.
  The name is the JAX package's (and its C-API bridge's); here it means the
  row-tile engine.  float32 ('c') only, as there.
* ``'pairs'``  -- ``ops/pairpanel.py``.  In 'z' the plan's pair table
  through the hand-written Hopper kernel K1 (``csrc/pairpanel_spmm.cu``).
  In 'c' the JAX package's packed engine: column groups (G from
  ``choose_group_size``), a Cuthill-McKee-relabelled resident union-ELL
  plan with ``r_tile`` 1, vectors as fused permuted panels, and the
  multiply K2 (``csrc/pairpanel_tiles.cu``).  On the CPU both run their
  plain versions.
* ``'xla'``    -- the block-list engine: the plain ``spmm_pairs``.
* ``'auto'``   -- the JAX package's rules (its solver.py:113-184): 'dense'
  while the dense planes fit ``DENSE_A_BYTE_LIMIT``, or A is at least 25%
  full and the planes take at most 4 GB; else, for 'c' with LM >= 8 and an
  X panel within ``PALLAS_X_BYTE_LIMIT``, 'pallas' unless its pack inflates
  A by more than 4x; else 'pairs'.  One difference is kept on purpose: the
  port's 'pairs' runs every pattern and every LM natively, so where the
  JAX package falls back to 'xla' the port stays on 'pairs'.

The block-list engines keep vectors as (re, im) planes [nnzbX, LM, LN] in
the plan's block order, the panel engines as [mb*LM, ncc, LN] panels, and
the packed 'pairs' engine as one fused panel [n_slots*LM, 2*G*LN].
Everything runs on the CUDA card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import core
from .bsr import Bsr
from .errors import Status, TfqmrgpuError, encode_status
from .ops import layout as layout_ops
from .ops import linalg
from .ops import pairpanel as pp_ops
from .ops import panel as panel_ops
from .ops.blocksparse import BlockSparseAction
from .ops.pallas_spmm import (RowTileMultiply, build_a_panels_device,
                              choose_row_tile)
from .plan import Plan, create_plan, resolve_device

ENGINES = ("auto", "dense", "pallas", "pairs", "xla")
PANEL_ENGINES = ("dense", "pallas")

# 'auto' takes 'dense' while both dense A planes fit in this many bytes, and
# the row-tile engine while both X panel planes (float32) fit in the other.
# These are the JAX package's values, sized for a TPU v5e's VMEM; an H100
# rule replaces them in later work, from the times chip_smoke.py prints.
DENSE_A_BYTE_LIMIT = int(64e6)
PALLAS_X_BYTE_LIMIT = 90 << 20
# the packed 'pairs' engine groups at most this many lanes (G*LN), as the
# JAX package's 'c' solver does
GROUP_LANE_LIMIT = 512


def choose_group_size(pairs: np.ndarray, pair_y: np.ndarray, nnzb_x: int,
                      lm: int, ln: int, row_of: np.ndarray,
                      colindx: np.ndarray, ncols: int) -> int:
    """The column group size of the packed 'pairs' engine, and the only
    place it is chosen: ``auto_group_size``'s full-iteration model (2
    multiplies and 15 vector passes at the card's rates) over G in
    (1, 2, 4, 8) with G*LN <= ``GROUP_LANE_LIMIT``; 1 for a single column."""
    if ncols < 2:
        return 1
    cands = tuple(g for g in (1, 2, 4, 8) if g * ln <= GROUP_LANE_LIMIT)
    g, _ = pp_ops.auto_group_size(pairs[:, 0], pairs[:, 1], pair_y, nnzb_x,
                                  lm, ln, row_of=row_of, col_of=colindx,
                                  candidates=cands)
    return g


def _dtype_for(precision: str) -> torch.dtype:
    if precision == "z":
        return torch.float64
    if precision == "c":
        return torch.float32
    if precision == "m":
        raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                            "mixed precision 'm' is not ported yet")
    raise TfqmrgpuError(encode_status(Status.PRECISION_MISSMATCH),
                        f"precision must be 'z' or 'c', got {precision!r}")


@dataclasses.dataclass
class SolveInfo:
    """getInfo parity (tfqmrgpu.cu:663-679), plus the probe count and the
    engine that ran."""

    residuum_reached: float
    iterations_needed: int
    flops_performed: float
    flops_performed_all: float
    return_status: int = 0
    rhs_status: Optional[np.ndarray] = None
    n_probes: int = 0
    engine: str = ""


class Solver:
    """Block-sparse tfQMR solver for A @ X == B on one device.

    Args:
      a, x, b: BSR operators.  A carries square [LM, LM] blocks, B carries
        [LM, LN] blocks, X gives the solution pattern (data optional).  B's
        pattern must be a subset of X's.
      precision: 'z' (complex128) or 'c' (complex64).
      engine: one of ``ENGINES`` (see the module docstring).
      device: where the plan, the matrices and the iteration live; the
        CUDA card unless given (``plan.resolve_device``).
      plan: an analysis result to reuse (``create_plan`` or
        ``convert.plan_from_numpy``); it is moved to ``device``.
      v3: the shadow vector as (re, im) [nnzbX, LM, LN] arrays or tensors;
        by default ``core.make_shadow_vector``.
    """

    def __init__(self, a: Bsr, x: Bsr, b: Bsr, *, precision: str = "z",
                 engine: str = "auto", index_offset: int = 0, echo: int = 0,
                 lm: int = 0, ln: int = 0, plan: Optional[Plan] = None,
                 device=None, v3=None):
        self.device = resolve_device(device)
        self.dtype = _dtype_for(precision)
        if engine not in ENGINES:
            raise TfqmrgpuError(
                encode_status(Status.NO_IMPLEMENTATION),
                f"engine {engine!r} is not ported; use one of {ENGINES}")
        self.plan = (plan.to(self.device) if plan is not None else
                     create_plan(a, x, b, index_offset=index_offset,
                                 echo=echo, device=self.device))
        self.precision = precision
        lm = lm or a.slow_block_dim or x.slow_block_dim or b.slow_block_dim
        ln = ln or b.fast_block_dim or x.fast_block_dim or lm
        if lm < 1:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "cannot infer block dims; attach data to A/B")
        if ln < lm:
            raise TfqmrgpuError(
                encode_status(Status.UNDOCUMENTED_ERROR),
                f"LN={ln} < LM={lm}: rectangular blocks need LN >= LM")
        self.lm, self.ln = int(lm), int(ln)
        self.plan.lm, self.plan.ln = self.lm, self.ln
        self.plan.precision = precision
        self._pack = None              # row-tile packing ('pallas')
        self.engine = self._choose_engine(engine, echo)
        # the packed 'pairs' engine ('c'): its plan and column groups
        self._packed = self.engine == "pairs" and precision == "c"
        self._pp_plan: Optional[pp_ops.PairPanelPlan] = None
        self._gp: Optional[pp_ops.GroupedPairs] = None
        if self._packed:
            self._pack_pairs(echo)

        self._panel = self.engine in PANEL_ENGINES
        self._layout = (panel_ops.PanelLayout.from_plan(self.plan)
                        if self._panel else None)
        self._cols = linalg.columns(self.plan.colindx, self.plan.ncols)
        self._multiply = None          # the engine's y = A @ x
        self._b: Optional[tuple] = None
        self._x0: Optional[tuple] = None
        self._x_result: Optional[tuple] = None
        if v3 is None:
            # the panel and packed engines pack v3 on the host before its
            # one upload
            v3 = core.make_shadow_vector(
                self.plan.nnzb_x, self.lm, self.ln,
                device="cpu" if self._panel or self._packed else self.device)
        self.set_shadow_vector(*v3)
        if a.data is not None:
            self.set_matrix("A", a.data)
        if b.data is not None:
            self.set_matrix("B", b.data)

    def _choose_engine(self, engine: str, echo: int) -> str:
        """Resolve 'auto' by the JAX package's rules, and build the row-tile
        pack for 'pallas'."""
        plan, auto = self.plan, engine == "auto"
        if auto:
            nr = plan.nrows * self.lm
            dense_bytes = 2 * nr * nr * (8 if self.precision == "z" else 4)
            a_fill = plan.nnzb_a / max(plan.nrows ** 2, 1)
            x_panel_bytes = 2 * nr * plan.ncols * self.ln * 4
            if dense_bytes <= DENSE_A_BYTE_LIMIT or (
                    a_fill >= 0.25 and dense_bytes <= int(4e9)):
                engine = "dense"
            elif (self.precision == "c" and self.lm >= 8
                  and x_panel_bytes <= PALLAS_X_BYTE_LIMIT):
                engine = "pallas"
            else:
                engine = "pairs"
        if engine == "pallas":
            if self.precision != "c":
                raise TfqmrgpuError(
                    encode_status(Status.PRECISION_MISSMATCH),
                    "the row-tile ('pallas') engine is float32-only; use "
                    "precision='c' or engine='dense'")
            pack = choose_row_tile(plan, self.lm)
            if auto and pack.inflation > 4.0:
                return "pairs"         # unions too ragged for row tiles
            self._pack = pack
            if echo > 2:
                print(f"# row-tile pack: {pack.ntiles} tiles x {pack.r_tile} "
                      f"rows, ku={pack.ku}, inflation {pack.inflation:.2f}x")
        return engine

    def _pack_pairs(self, echo: int):
        """The packed plan of the 'c' 'pairs' engine (JAX: the fine branch
        of its solver's ``_build_fine_pairs``): the group size, the grouped
        pair list (ungrouped if ``pack_grouped`` refuses the pattern), then
        the resident plan with ``r_tile`` 1."""
        plan = self.plan
        pairs = plan.pairs.cpu().numpy().astype(np.int64)
        pair_y = np.repeat(np.arange(plan.nnzb_x, dtype=np.int64),
                           np.diff(plan.starts.cpu().numpy()))
        row_of = np.repeat(np.arange(plan.nrows, dtype=np.int64),
                           np.diff(plan.rowptr_x))
        colindx = plan.colindx.cpu().numpy().astype(np.int64)
        g = choose_group_size(pairs, pair_y, plan.nnzb_x, self.lm, self.ln,
                              row_of, colindx, plan.ncols)
        if g > 1:
            try:
                self._gp = pp_ops.pack_grouped(
                    pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x, self.ln,
                    g, row_of=row_of, col_of=colindx)
            except ValueError:
                self._gp = None
        gp = self._gp
        if gp is not None:
            self._pp_plan = pp_ops.pack_pair_plan(
                gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2,
                self.lm, gp.ln2, r_tile=1, row_of=gp.row_of2,
                col_of=gp.col_of2)
        else:
            self._pp_plan = pp_ops.pack_pair_plan(
                pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x, plan.nnzb_x,
                self.lm, self.ln, r_tile=1, row_of=row_of, col_of=colindx)
        if echo > 2:
            pp = self._pp_plan
            print(f"# packed pairs: G={gp.group_size if gp else 1}, "
                  f"{pp.ntiles} tiles, ku={pp.ku}, lanes {2 * pp.ln}, "
                  f"inflation {pp.inflation:.2f}x")

    def _pairs_permute(self, re: np.ndarray, im: np.ndarray) -> np.ndarray:
        """X-shaped block planes -> the packed engine's fused panel
        (column grouping, then the relabelling)."""
        if self._gp is not None:
            re = pp_ops.grouped_blocks(self._gp, re)
            im = pp_ops.grouped_blocks(self._gp, im)
        return pp_ops.permute_x(self._pp_plan, re, im)

    def _pairs_unpermute(self, fused: np.ndarray) -> tuple:
        """The fused panel -> (re, im) block planes [nnzbX, LM, LN]."""
        re, im = pp_ops.unpermute_y(self._pp_plan, fused)
        if self._gp is not None:
            re = pp_ops.ungroup_blocks(self._gp, re)
            im = pp_ops.ungroup_blocks(self._gp, im)
        return re, im

    def _pairs_b_panel(self, re: np.ndarray, im: np.ndarray) -> torch.Tensor:
        """B blocks scattered into X's shape, grouped, permuted into the
        fused panel, uploaded."""
        shape = (self.plan.nnzb_x, self.lm, self.ln)
        xr, xi = np.zeros(shape, re.dtype), np.zeros(shape, im.dtype)
        sub = self.plan.subset.cpu().numpy().astype(np.int64)
        np.add.at(xr, sub, re)
        np.add.at(xi, sub, im)
        return torch.from_numpy(self._pairs_permute(xr, xi)).to(self.device)

    # ------------------------------------------------------------- matrices

    def set_shadow_vector(self, re, im):
        """Install v3 (float32 [nnzbX, LM, LN], numpy or torch); the panel
        engines pack it into a float32 panel on the host, then upload it."""
        shape = (self.plan.nnzb_x, self.lm, self.ln)
        if any(tuple(v.shape) != shape for v in (re, im)):
            raise ValueError(f"v3 must have shape {shape}")
        if self._panel or self._packed:
            host = [np.asarray(v.cpu() if torch.is_tensor(v) else v,
                               dtype=np.float32) for v in (re, im)]
            if self._packed:
                self._v3 = torch.from_numpy(
                    self._pairs_permute(*host)).to(self.device)
            else:
                self._v3 = self._upload(*(self._layout.pack_x(h)
                                          for h in host))
        else:
            self._v3 = tuple((v if torch.is_tensor(v) else torch.from_numpy(
                np.array(v, dtype=np.float32))).to(self.device, torch.float32)
                for v in (re, im))

    def _upload(self, re: np.ndarray, im: np.ndarray) -> tuple:
        return (torch.from_numpy(re).to(self.device),
                torch.from_numpy(im).to(self.device))

    def set_matrix(self, var: str, val, *, trans: str = "n",
                   layout: int = layout_ops.LAYOUT_RIRIRIRI,
                   scale: float = 1.0, conjugate: bool = False):
        """Upload 'A', 'B' or the initial guess 'X' (setMatrix parity,
        tfqmrgpu.cu:609-621): a complex array [nnzb, d1, d2] or a real
        array in one of the reference's layouts; ``trans`` takes
        'n'/'t'/'h'/'c'/'*' and composes with ``conjugate``."""
        var = var.upper()
        npdt = np.float64 if self.dtype == torch.float64 else np.float32
        dims = {"A": (self.plan.nnzb_a, self.lm, self.lm),
                "B": (self.plan.nnzb_b, self.lm, self.ln),
                "X": (self.plan.nnzb_x, self.lm, self.ln)}
        if var not in dims:
            raise TfqmrgpuError(
                encode_status(Status.VARIABLENAME_UNKNOWN, 0, var[:1] or "?"),
                f"var={var!r}")
        re, im = layout_ops.to_planes(np.asarray(val), *dims[var], trans=trans,
                                      layout=layout, scale=scale,
                                      conjugate=conjugate, dtype=npdt)
        lay = self._layout
        if var == "A":
            self._multiply = self._make_multiply(re, im)
        elif var == "B":
            if self._packed:
                self._b = self._pairs_b_panel(re, im)
            else:
                self._b = (self._upload(lay.pack_b(re), lay.pack_b(im))
                           if self._panel else self._upload(re, im))
        else:
            # initial guess X0: solve A*dX == B - A*X0 and return X0 + dX
            # (the reference always starts from zero, tfqmrgpu_core.hxx:125)
            if self._packed:
                self._x0 = torch.from_numpy(
                    self._pairs_permute(re, im)).to(self.device)
            else:
                self._x0 = (self._upload(lay.pack_x(re), lay.pack_x(im))
                            if self._panel else self._upload(re, im))

    def _make_multiply(self, re: np.ndarray, im: np.ndarray):
        """The engine's y = A @ x over A's (re, im) block planes."""
        if self.engine == "dense":
            lay = self._layout
            a_re, a_im = self._upload(*lay.densify_a(self.plan, re, im))
            mask4 = torch.from_numpy(lay.mask[:, None, :, None]).to(
                self.device, self.dtype)
            return panel_ops.dense_multiply(a_re, a_im, mask4, lay.mb,
                                            lay.lm, lay.ncc, lay.ln)
        a_re, a_im = self._upload(re, im)
        if self._packed:
            return pp_ops.PairPanelMultiply(
                self._pp_plan,
                pp_ops.build_a_panels_device(self._pp_plan, a_re, a_im))
        if self.engine == "pallas":
            return RowTileMultiply(
                self._pack, build_a_panels_device(self._pack, a_re),
                build_a_panels_device(self._pack, a_im), self._layout.mask,
                self.ln)
        if self.engine == "pairs":
            return pp_ops.PairPlanMultiply(self.plan, a_re, a_im, self.ln)
        return BlockSparseAction.from_plan(self.plan, a_re, a_im)

    def get_matrix(self, var: str = "X", *, trans: str = "n",
                   layout: Optional[int] = None,
                   conjugate: bool = False) -> np.ndarray:
        """The solution X on the host, complex [nnzbX, LM, LN], or a real
        array in ``layout`` (getMatrix parity, tfqmrgpu.cu:624-645)."""
        if var.upper() != "X":
            raise TfqmrgpuError(
                encode_status(Status.VARIABLENAME_UNKNOWN, 0, var[:1] or "?"),
                "getMatrix supports only 'X'")
        if self._x_result is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "solve() has not been called")
        if self._packed:
            re, im = self._pairs_unpermute(self._x_result.cpu().numpy())
        else:
            re, im = (t.cpu().numpy() for t in self._x_result)
        if self._panel:
            re, im = self._layout.unpack_x(re), self._layout.unpack_x(im)
        if layout is not None:
            return layout_ops.from_planes(re, im, trans=trans, layout=layout,
                                          conjugate=conjugate)
        t, conj = layout_ops.resolve_transposition(trans, conjugate)
        if t == "t":
            re, im = np.swapaxes(re, 1, 2), np.swapaxes(im, 1, 2)
        return layout_ops.planes_to_complex(re, -im if conj else im)

    # ---------------------------------------------------------------- solve

    def solve(self, tolerance: float = 1e-6, max_iterations: int = 999,
              rhs_trivial: bool = False) -> SolveInfo:
        """Run tfQMR; ``rhs_trivial`` solves for unit blocks in B's
        pattern instead of B's data."""
        if self._multiply is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "matrix 'A' has not been set")
        if self._b is None and not rhs_trivial:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "matrix 'B' has not been set")
        if self._panel:
            result = self._solve_panel(tolerance, max_iterations, rhs_trivial)
        elif self._packed:
            result = self._solve_fused(tolerance, max_iterations, rhs_trivial)
        else:
            result = self._solve_blocks(tolerance, max_iterations,
                                        rhs_trivial)
        return self._finish_solve(result, max_iterations)

    def _solve_blocks(self, tolerance, max_iterations, rhs_trivial):
        """The block-list engines ('pairs', 'xla')."""
        multiply = self._multiply
        plan = self.plan
        kw = dict(lm=self.lm, ln=self.ln)
        if self._x0 is not None and not rhs_trivial:
            x0 = self._x0
            z = torch.zeros_like(x0[0])
            bx = linalg.add_rhs((z, z), self._b, 1.0, plan.subset)
            ax0 = multiply(x0)
            bp = (bx[0] - ax0[0], bx[1] - ax0[1])
            # keep the convergence target relative to the original |B|
            inv = core.inverse_norms(linalg.nrm2(bx, self._cols))
            ident = torch.arange(plan.nnzb_x, dtype=torch.int32,
                                 device=self.device)
            result = core.solve_core(multiply, bp, self._v3, self._cols, ident,
                                     tolerance, max_iterations, inv, **kw)
            return result._replace(x=(result.x[0] + x0[0],
                                      result.x[1] + x0[1]))
        b = self._b
        if b is None:          # trivial RHS: a shape placeholder
            z = torch.zeros((plan.nnzb_b, self.lm, self.ln),
                            dtype=self.dtype, device=self.device)
            b = (z, z)
        return core.solve_core(multiply, b, self._v3, self._cols,
                               plan.subset, tolerance, max_iterations,
                               rhs_trivial=rhs_trivial, **kw)

    def _solve_panel(self, tolerance, max_iterations, rhs_trivial):
        """The panel engines ('dense', 'pallas'), as the JAX package's
        _solve_panel and _solve_shifted."""
        multiply = self._multiply
        if self._x0 is not None and not rhs_trivial:
            x0, b = self._x0, self._b
            ax0 = multiply(x0)
            bp = (b[0] - ax0[0], b[1] - ax0[1])
            # keep the convergence target relative to the original |B|
            inv = core.inverse_norms(
                (b[0].double() ** 2 + b[1].double() ** 2).sum(dim=0))
            result = core.solve_core_panel(multiply, bp, self._v3, tolerance,
                                           max_iterations, inv)
            return result._replace(x=(result.x[0] + x0[0],
                                      result.x[1] + x0[1]))
        if rhs_trivial:
            lay = self._layout
            npdt = np.float64 if self.dtype == torch.float64 else np.float32
            unit = lay.unit_b_blocks(npdt)
            b = self._upload(lay.pack_b(unit), lay.pack_b(np.zeros_like(unit)))
        else:
            b = self._b
        return core.solve_core_panel(multiply, b, self._v3, tolerance,
                                     max_iterations, rhs_trivial=rhs_trivial)

    def _solve_fused(self, tolerance, max_iterations, rhs_trivial):
        """The packed 'pairs' engine, as the JAX package's _solve_pairs and
        _solve_shifted."""
        plan, ncc = self._pp_plan, self.plan.ncols

        def run(b, inv=None):
            prim = pp_ops.fused_primitives(self._multiply, plan, ncc, b,
                                           self._gp)
            return core.solve_core_fused(prim, b, self._v3, ncc, self.ln,
                                         tolerance, max_iterations, inv,
                                         rhs_trivial=rhs_trivial)

        if self._x0 is not None and not rhs_trivial:
            x0, b = self._x0, self._b
            prim = pp_ops.fused_primitives(self._multiply, plan, ncc, b,
                                           self._gp)
            # keep the convergence target relative to the original |B|
            result = run(b - prim.multiply(x0),
                         core.inverse_norms(prim.nrm2(b)))
            return result._replace(x=result.x + x0)
        if rhs_trivial:
            unit = linalg.set_unit_blocks(self.plan.nnzb_b, self.lm, self.ln,
                                          torch.float32)[0].numpy()
            return run(self._pairs_b_panel(unit, np.zeros_like(unit)))
        return run(self._b)

    def _finish_solve(self, result: core.SolveResult,
                      max_iterations: int) -> SolveInfo:
        self._x_result = result.x
        iters = result.iterations
        if result.return_status != int(Status.SUCCESS):
            iters = min(int(max_iterations), iters)
        p = self.plan
        if self._panel:
            # the JAX package's panel accounting (its solver.py:1013-1028)
            lay = self._layout
            nb_panel = lay.mb * lay.ncc          # panel positions incl. zeros
            spmm = (panel_ops.flops_dense_multiply(lay.mb, lay.lm, lay.ncc,
                                                   lay.ln)
                    if self.engine == "dense" else
                    p.nnzb_a * 8.0 * lay.lm * lay.lm * lay.ncc * lay.ln)
            per_iter = (2 * spmm
                        + 2 * linalg.flops_dotp(nb_panel, lay.lm, lay.ln)
                        + 2 * linalg.flops_nrm2(nb_panel, lay.lm, lay.ln)
                        + 10 * linalg.flops_axpy(nb_panel, lay.lm, lay.ln))
            per_probe = spmm + linalg.flops_nrm2(nb_panel, lay.lm, lay.ln)
        else:
            per_iter = core.flops_per_iteration(p.n_pairs, p.nnzb_x,
                                                self.lm, self.ln)
            per_probe = core.flops_per_probe(p.n_pairs, p.nnzb_x, self.lm,
                                             self.ln)
        flops = iters * per_iter + result.n_probes * per_probe
        p.residuum_reached = result.residuum
        p.iterations_needed = iters
        p.flops_performed = flops
        p.flops_performed_all += flops
        return SolveInfo(
            residuum_reached=result.residuum, iterations_needed=iters,
            flops_performed=flops, flops_performed_all=p.flops_performed_all,
            return_status=result.return_status,
            rhs_status=result.rhs_status.cpu().numpy(),
            n_probes=result.n_probes, engine=self.engine)


# ------------------------------------------------------------- one-callers

def solve(a: Bsr, x: Bsr, b: Bsr, *, precision: str = "z",
          tolerance: float = 1e-6, max_iterations: int = 999,
          engine: str = "auto", index_offset: int = 0, echo: int = 0,
          device=None) -> tuple[Bsr, SolveInfo]:
    """One-call solve: returns (X with data attached, SolveInfo)
    (tfqmrgpu_bsrsv, tfqmrgpu.cu:700-791), on the CUDA card unless
    ``device`` is given."""
    s = Solver(a, x, b, precision=precision, engine=engine,
               index_offset=index_offset, echo=echo, device=device)
    info = s.solve(tolerance=tolerance, max_iterations=max_iterations)
    return x.with_data(s.get_matrix("X")), info


def bsrsv_z(a, x, b, **kw):
    """complex128 one-call solve (tfqmrgpu_bsrsv_z, tfqmrgpu.cu:796-809)."""
    kw.setdefault("precision", "z")
    return solve(a, x, b, **kw)


def bsrsv_c(a, x, b, **kw):
    """complex64 one-call solve (tfqmrgpu_bsrsv_c, tfqmrgpu.cu:812-822)."""
    kw.setdefault("precision", "c")
    return solve(a, x, b, **kw)

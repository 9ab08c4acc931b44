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
  ``choose_group_size``, or TFQ_PAIRS_COLGROUP), a Cuthill-McKee-relabelled
  resident union-ELL plan with ``r_tile`` 1 (or TFQ_PAIRS_RTILE), vectors
  as fused permuted panels, and the multiply K2
  (``csrc/pairpanel_tiles.cu``).  At LM <= 8 the 'c' engine first tries
  the JAX package's superblock composition (``pack_superblock``): f block
  rows merged into LM' = f*LM (16 or 32), so that K2 runs the merged plan.
  TFQ_SOLVER_SUPER picks it: 'auto' (the default) where the problem has
  at least TFQ_SUPER_MIN_MACS fine MACs (1e6) and the card's measured
  rates (``ops/rates.py``) say it pays, N forces the factor N, 0 turns it
  off; a pattern it cannot pack falls back to the fine pack.  'z' runs
  K1 on the plan's pair table at every LM and never merges, unless
  TFQ_PAIRS_Z_OZ=1 (below).  On the CPU both run their plain versions.
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

Precision modes of 'c', the JAX package's knobs: TFQ_PAIRS_MM_PREC picks
K2's matmul precision in the packed 'pairs' engine and TFQ_PALLAS_MM_PREC
K3's in 'pallas', each one of ``ops/pairpanel.PRECISIONS`` ('highest', the
default, is exact FP32; 'bf16', 'bf16x3', 'bf16x4' and 'bf16x6' run the
bf16 split products on the BF16 tensor cores).  As in the JAX package the
packed engine runs 'highest' at a kernel LM below 16, and K3 runs 'highest'
for 'bf16'; an unknown string raises ValueError.  The float64 engines take
the JAX package's Ozaki opt-ins: TFQ_XLA_OZ=1 for 'xla' and TFQ_Z_OZAKI=1
for 'dense' (both '0' by default here, '1' in the JAX package, whose TPU
has no float64 unit), and TFQ_PAIRS_Z_OZ=1 (default '0') for 'pairs': 'z'
then takes the JAX package's packed route (its solver.py:134-262,
609-645) on the oz kernel (``csrc/pairpanel_oz.cu``,
``ops/pairpanel.OzPairPanelMultiply``): the superblock at LM <= 8 (under
TFQ_SOLVER_SUPER, by the oz kernel's rates in ``ops/rates.py``), column
groups of at most 256 lanes, the multiply built in 'xi8' (TFQ_OZC_INT8 "2")
or, where its mixed fallback fails its depth bound, with bf16 X slices
("0"), TFQ_OZC_INT8 pinning the mode and TFQ_OZ_COMP / TFQ_OZ_INT8 the
legacy 'oz' mode, and float64 fused panels.  Where the kernel LM stays
below 16 an explicit 'pairs' raises PRECISION_MISSMATCH and 'auto' takes
'xla', as in the JAX package.

Mixed precision 'm' is no ``Solver`` precision: ``solve(precision='m')``,
``solve_mixed`` and ``bsrsv_m`` run a 'c' solve, refine it against a
float64 residual (``refine_mixed``, ``refine.py``) and fall back to 'z'
only when the refinement stalls.  ``Solver.solve_checkpointed`` solves in
restart chunks with a state file.
"""

from __future__ import annotations

import dataclasses
import os
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
from .ops import rates
from .ops import superblock as sb_ops
from .ops.blocksparse import BlockSparseAction
from .ops.pallas_spmm import (RowTileMultiply, build_a_panels_device,
                              choose_row_tile)
from .plan import Plan, create_plan, resolve_device
from .profiling import trace

ENGINES = ("auto", "dense", "pallas", "pairs", "xla")
PANEL_ENGINES = ("dense", "pallas")

# 'auto' takes 'dense' while both dense A planes fit in this many bytes, and
# the row-tile engine while both X panel planes (float32) fit in the other.
# These are the JAX package's values, sized for a TPU v5e's VMEM; an H100
# rule replaces them in later work, from the times chip_smoke.py prints.
DENSE_A_BYTE_LIMIT = int(64e6)
PALLAS_X_BYTE_LIMIT = 90 << 20
# the packed 'pairs' engine groups at most this many lanes (G*LN), as the
# JAX package's solver does: 512 in 'c', 256 in 'z' (its solver.py:350-356)
GROUP_LANE_LIMIT = 512
Z_GROUP_LANE_LIMIT = 256


def choose_group_size(pairs: np.ndarray, pair_y: np.ndarray, nnzb_x: int,
                      lm: int, ln: int, row_of: np.ndarray,
                      colindx: np.ndarray, ncols: int,
                      lane_limit: int = GROUP_LANE_LIMIT) -> int:
    """The column group size of the packed 'pairs' engine, and the only
    place it is chosen: ``auto_group_size``'s full-iteration model (2
    multiplies and 15 vector passes at the card's rates) over G in
    (1, 2, 4, 8) with G*LN <= ``lane_limit`` (``GROUP_LANE_LIMIT``, or
    ``Z_GROUP_LANE_LIMIT`` in 'z'); 1 for a single column, and 1 where the
    model raises ``ValueError`` (the JAX solver's "do not group", its
    solver.py:357-374).  The model prices FP32 K2 in 'z' too."""
    if ncols < 2:
        return 1
    cands = tuple(g for g in (1, 2, 4, 8) if g * ln <= lane_limit)
    try:
        g, _ = pp_ops.auto_group_size(pairs[:, 0], pairs[:, 1], pair_y,
                                      nnzb_x, lm, ln, row_of=row_of,
                                      col_of=colindx, candidates=cands)
    except ValueError:
        return 1
    return g


def oz_multiply(pp_plan, a_re: torch.Tensor, a_im: torch.Tensor):
    """The packed 'z' multiply on the oz kernel over float64 A blocks (the
    JAX solver's set_matrix, its solver.py:609-645): TFQ_OZC_INT8 pins the
    mode; unset, 'xi8' ("2") is tried first and the bf16 X slices ("0")
    where its mixed fallback fails the float32 depth bound."""
    oz_i8 = os.environ.get("TFQ_OZC_INT8", "2")
    tries = [oz_i8] if "TFQ_OZC_INT8" in os.environ else [oz_i8, "0"]
    for n_try, i8_try in enumerate(tries):
        try:
            return pp_ops.make_pairpanel_multiply_oz(pp_plan, a_re, a_im,
                                                     int8=i8_try)
        except ValueError:
            if n_try == len(tries) - 1:
                raise


def _pair_lists(plan) -> tuple:
    """The plan's pair list on the host: (pairs int64[nPairs, 2] of (A, X)
    blocks, the Y block of each pair, the block row and the compressed
    column of each X block)."""
    pair_y = np.repeat(np.arange(plan.nnzb_x, dtype=np.int64),
                       np.diff(plan.starts.cpu().numpy()))
    row_of = np.repeat(np.arange(plan.nrows, dtype=np.int64),
                       np.diff(plan.rowptr_x))
    return (plan.pairs.cpu().numpy().astype(np.int64), pair_y, row_of,
            plan.colindx.cpu().numpy().astype(np.int64))


def pack_pairs(plan, lm: int, ln: int, group_size: Optional[int] = None,
               r_tile: Optional[int] = None,
               lane_limit: int = GROUP_LANE_LIMIT) -> tuple:
    """The packed plan of the 'c' 'pairs' engine, from the plan's pair list
    (JAX: the fine branch of its solver's ``_build_fine_pairs``): the group
    size (``choose_group_size`` for 0, none for 1, else ``group_size``),
    the grouped pair list (ungrouped if ``pack_grouped`` refuses the
    pattern, as it does a single column), then the resident plan in tiles
    of ``r_tile`` rows.  ``None`` reads the JAX solver's knobs (its solver.py:330-334),
    which ``autotune`` races: TFQ_PAIRS_COLGROUP for the group size
    (default 0) and TFQ_PAIRS_RTILE for ``r_tile`` (default 1).  Returns
    (``GroupedPairs`` or None, ``PairPanelPlan``)."""
    if group_size is None:
        group_size = int(os.environ.get("TFQ_PAIRS_COLGROUP", "0"))
    if r_tile is None:
        r_tile = int(os.environ.get("TFQ_PAIRS_RTILE", "1"))
    pairs, pair_y, row_of, colindx = _pair_lists(plan)
    g = int(group_size) or choose_group_size(
        pairs, pair_y, plan.nnzb_x, lm, ln, row_of, colindx, plan.ncols,
        lane_limit)
    gp = None
    if g > 1:
        try:
            gp = pp_ops.pack_grouped(pairs[:, 0], pairs[:, 1], pair_y,
                                     plan.nnzb_x, ln, g, row_of=row_of,
                                     col_of=colindx)
        except ValueError:
            gp = None
    if gp is not None:
        return gp, pp_ops.pack_pair_plan(
            gp.pair_a2, gp.pair_x2, gp.pair_y2, gp.nnzb2, gp.nnzb2, lm,
            gp.ln2, r_tile=r_tile, row_of=gp.row_of2, col_of=gp.col_of2)
    return None, pp_ops.pack_pair_plan(
        pairs[:, 0], pairs[:, 1], pair_y, plan.nnzb_x, plan.nnzb_x, lm, ln,
        r_tile=r_tile, row_of=row_of, col_of=colindx)


def pack_superblock(plan, lm: int, ln: int, sup_env: str = "auto",
                    precision: str = "c") -> tuple:
    """The superblock composition of the packed 'c' engine (JAX: its
    solver's ``_build_superblock``, solver.py:473-570): for each factor f
    (``sup_env`` forces one; 'auto' tries {16 // LM, 32 // LM}, f >= 2) the
    lanes are widened first by ``pack_grouped`` toward
    max(ceil(LM'/LN), ceil(32/LN)) column groups, capped at the columns
    (a narrow-lane merged plan, LN < LM', is legal inside merged space),
    then f block rows merge (``superblock.pack_rowmerge``); the factor with
    the least MAC inflation / ``rates.engine_rate`` wins, and the merged
    pair list is packed at TFQ_PAIRS_RTILE (default 1).

    Under 'auto' a problem below TFQ_SUPER_MIN_MACS fine MACs (1e6),
    merged sizes the card's table has not measured, and a winner whose
    cost is not below 1 / ``rates.base_rate`` are refused; a forced factor
    bypasses the floor and the rates.  Host numpy only; raises ValueError
    where nothing packs or merging does not pay.  Returns
    (``RowMerge``, ``GroupedPairs`` or None, ``PairPanelPlan``)."""
    auto = sup_env in ("auto", "")
    pairs, pair_y, row_of, col_of = _pair_lists(plan)
    pa, px = pairs[:, 0], pairs[:, 1]
    # too small a problem: the transform's masking, permutes and MAC
    # inflation swamp the rates the cost model is built on
    mac_fine = float(pa.shape[0]) * lm * lm * ln
    min_macs = float(os.environ.get("TFQ_SUPER_MIN_MACS", "1e6"))
    if auto and mac_fine < min_macs:
        raise ValueError("problem too small for the superblock transform "
                         f"({mac_fine:.0f} fine MACs < {min_macs:.0f})")
    rt = int(os.environ.get("TFQ_PAIRS_RTILE", "1"))
    cands = ([int(sup_env)] if not auto else
             sorted({f for f in (16 // lm, 32 // lm) if f >= 2}))
    best = None
    for f in cands:
        lm2 = f * lm
        fc = min(max(-(-lm2 // ln), -(-32 // ln)), plan.ncols)
        gp = None
        if fc > 1:
            try:
                gp = pp_ops.pack_grouped(pa, px, pair_y, plan.nnzb_x, ln, fc,
                                         row_of=row_of, col_of=col_of)
            except ValueError:
                gp = None
        if gp is not None:
            rm = sb_ops.pack_rowmerge(gp.pair_a2, gp.pair_x2, gp.pair_y2,
                                      gp.nnzb2, lm, gp.ln2, f,
                                      row_of=gp.row_of2, col_of=gp.col_of2,
                                      verify=False)
        else:
            rm = sb_ops.pack_rowmerge(pa, px, pair_y, plan.nnzb_x, lm, ln, f,
                                      row_of=row_of, col_of=col_of)
        rate = rates.engine_rate(precision, lm2)
        if not rate:
            if auto:
                continue          # unmeasured merged size: not for 'auto'
            rate = 1.0
        cost = rm.mac_inflation / rate
        if best is None or cost < best[0]:
            best = (cost, gp, rm)
    if best is None:
        raise ValueError("no feasible superblock factor")
    if auto and best[0] >= 1.0 / rates.base_rate(precision, lm):
        raise ValueError(f"superblock does not pay on this pattern (cost "
                         f"{best[0]:.4f} vs fine-grained "
                         f"{1.0 / rates.base_rate(precision, lm):.4f})")
    _, gp, rm = best
    return rm, gp, pp_ops.pack_pair_plan(
        rm.pair_a2, rm.pair_x2, rm.pair_y2, rm.n_cells, rm.n_cells, rm.lm2,
        rm.ln, r_tile=rt, row_of=rm.row_of2, col_of=rm.col_of2)


def _dtype_for(precision: str) -> torch.dtype:
    if precision == "z":
        return torch.float64
    if precision == "c":
        return torch.float32
    if precision == "m":
        raise TfqmrgpuError(
            encode_status(Status.PRECISION_MISSMATCH),
            "a Solver runs 'z' or 'c'; mixed precision 'm' runs through "
            "solve(precision='m'), solve_mixed or bsrsv_m")
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
    # mixed precision ('m'): the c stage's engine, iterations and residuum,
    # the refinement rounds, the iterations before any 'z' fallback, and
    # whether it ran
    refinement: Optional[dict] = None


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
        # the packed 'pairs' engine ('c', and 'z' under TFQ_PAIRS_Z_OZ): its
        # plan and column groups
        self._z_oz = precision == "z" and pp_ops.z_oz_enabled()
        self._packed = self.engine == "pairs" and (precision == "c"
                                                   or self._z_oz)
        self._pp_plan: Optional[pp_ops.PairPanelPlan] = None
        self._gp: Optional[pp_ops.GroupedPairs] = None
        # the superblock row merge and its fused live-slot mask (device)
        self._sup: Optional[sb_ops.RowMerge] = None
        self._sup_mask: Optional[torch.Tensor] = None
        if self._packed:
            try:
                self._pack_pairs(echo)
            except ValueError as e:
                # the JAX solver's fallback (its solver.py:229-239)
                if engine != "auto":
                    if self._z_oz and self.lm < 16:
                        raise TfqmrgpuError(
                            encode_status(Status.PRECISION_MISSMATCH),
                            "the pairs engine's 'z' (Ozaki) kernel needs a "
                            "kernel LM >= 16 and the superblock merge did "
                            f"not pack ({e}); use engine='dense' or "
                            "'xla'") from e
                    raise TfqmrgpuError(
                        encode_status(Status.UNDOCUMENTED_ERROR),
                        f"the packed 'pairs' engine cannot pack this "
                        f"pattern ({e}); use engine='xla'") from e
                self._drop_pack()
        if self._z_oz and self._packed and self._pp_plan.lm < 16:
            # the JAX solver's rule for its Ozaki kernel (its
            # solver.py:249-264): 'auto' goes to the block-list engine
            if engine != "auto":
                raise TfqmrgpuError(
                    encode_status(Status.PRECISION_MISSMATCH),
                    "the pairs engine's 'z' (Ozaki) kernel needs a kernel "
                    f"LM >= 16, got {self._pp_plan.lm}; use engine='dense' "
                    "or 'xla'")
            self._drop_pack()
        # K2's matmul precision (the JAX solver's, its solver.py:241-248):
        # TFQ_PAIRS_MM_PREC, coerced to 'highest' at a kernel LM below 16,
        # where the JAX kernel's bf16 windows cannot tile (a superblock's
        # merged LM' of 16 or 32 lifts that)
        self.pairs_prec = "highest"
        if self._packed and precision == "c":
            prec = pp_ops.check_precision(
                os.environ.get("TFQ_PAIRS_MM_PREC", "highest"))
            self.pairs_prec = prec if self._pp_plan.lm >= 16 else "highest"

        self._panel = self.engine in PANEL_ENGINES
        self._layout = (panel_ops.PanelLayout.from_plan(self.plan)
                        if self._panel else None)
        self._cols = linalg.columns(self.plan.colindx, self.plan.ncols)
        self._multiply = None          # the engine's y = A @ x
        self._b: Optional[tuple] = None
        self._bn2: Optional[np.ndarray] = None   # B's column norms^2
        self._x0: Optional[tuple] = None
        self._x_result: Optional[tuple] = None
        self._info: Optional[SolveInfo] = None
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

    def _drop_pack(self):
        """Leave the packed engine for the block-list engine 'xla'."""
        self.engine, self._packed = "xla", False
        self._pp_plan = self._gp = self._sup = self._sup_mask = None

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
            r_env = os.environ.get("TFQ_PALLAS_RTILE")  # JAX's knob
            pack = choose_row_tile(plan, self.lm,
                                   r_tile=int(r_env) if r_env else None)
            if auto and pack.inflation > 4.0:
                return "pairs"         # unions too ragged for row tiles
            self._pack = pack
            if echo > 2:
                print(f"# row-tile pack: {pack.ntiles} tiles x {pack.r_tile} "
                      f"rows, ku={pack.ku}, inflation {pack.inflation:.2f}x")
        return engine

    def _pack_pairs(self, echo: int):
        """The packed plan of the 'pairs' engine ('c', or 'z' under
        TFQ_PAIRS_Z_OZ): at LM <= 8 the superblock (``pack_superblock``
        under TFQ_SOLVER_SUPER, unless it is 0), where it packs, else
        ``pack_pairs`` under TFQ_PAIRS_COLGROUP and TFQ_PAIRS_RTILE, with
        groups of at most ``Z_GROUP_LANE_LIMIT`` lanes in 'z'.  In 'z' a
        superblock that does not pack raises its ValueError, as the JAX
        solver does (the fine pack at LM <= 8 cannot run the Ozaki
        kernel)."""
        sup_env = os.environ.get("TFQ_SOLVER_SUPER", "auto")
        if sup_env != "0" and self.lm <= 8:
            try:
                self._sup, self._gp, self._pp_plan = pack_superblock(
                    self.plan, self.lm, self.ln, sup_env, self.precision)
            except ValueError as e:
                if echo > 2:
                    print(f"# superblock unavailable ({e}); fine-grained "
                          "pairs")
                if self._z_oz:
                    raise
        if self._sup is not None:
            rm = self._sup
            mask = sb_ops.merged_mask_full(rm, self._gp)
            self._sup_mask = torch.from_numpy(
                pp_ops.permute_x(self._pp_plan, mask, mask)).to(
                    self.device, self.dtype)
            if echo > 2:
                pp = self._pp_plan
                print(f"# superblock: f_row {rm.f_row}, LM' {rm.lm2}, lanes "
                      f"{2 * rm.ln}, {rm.n_cells} cells, {rm.n_acells} A "
                      f"cells, MAC inflation {rm.mac_inflation:.2f}x; "
                      f"{pp.ntiles} tiles, ku {pp.ku}")
            return
        self._gp, self._pp_plan = pack_pairs(
            self.plan, self.lm, self.ln,
            lane_limit=Z_GROUP_LANE_LIMIT if self._z_oz else GROUP_LANE_LIMIT)
        if echo > 2:
            pp, gp = self._pp_plan, self._gp
            print(f"# packed pairs: G={gp.group_size if gp else 1}, "
                  f"{pp.ntiles} tiles, ku={pp.ku}, lanes {2 * pp.ln}, "
                  f"inflation {pp.inflation:.2f}x")

    def _pairs_permute(self, re: np.ndarray, im: np.ndarray) -> np.ndarray:
        """X-shaped block planes -> the packed engine's fused panel
        (column grouping, then the superblock row merge, which zeroes the
        dead slots, then the relabelling)."""
        if self._gp is not None:
            re = pp_ops.grouped_blocks(self._gp, re)
            im = pp_ops.grouped_blocks(self._gp, im)
        if self._sup is not None:
            re = sb_ops.merge_xy_blocks(self._sup, re)
            im = sb_ops.merge_xy_blocks(self._sup, im)
        return pp_ops.permute_x(self._pp_plan, re, im)

    def _pairs_unpermute(self, fused: np.ndarray) -> tuple:
        """The fused panel -> (re, im) block planes [nnzbX, LM, LN]."""
        re, im = pp_ops.unpermute_y(self._pp_plan, fused)
        if self._sup is not None:
            re = sb_ops.unmerge_xy_blocks(self._sup, re)
            im = sb_ops.unmerge_xy_blocks(self._sup, im)
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
            # float32 values; the packed 'z' engine holds them in float64
            # (the JAX solver's astype)
            npdt = np.float64 if self._packed and self._z_oz else np.float32
            self._v3 = self._upload_x(*(
                np.asarray(v.cpu() if torch.is_tensor(v) else v,
                           dtype=np.float32).astype(npdt) for v in (re, im)))
        else:
            self._v3 = tuple((v if torch.is_tensor(v) else torch.from_numpy(
                np.array(v, dtype=np.float32))).to(self.device, torch.float32)
                for v in (re, im))

    def _upload(self, re: np.ndarray, im: np.ndarray) -> tuple:
        return (torch.from_numpy(re).to(self.device),
                torch.from_numpy(im).to(self.device))

    def _upload_x(self, re: np.ndarray, im: np.ndarray):
        """X-shaped host planes [nnzbX, LM, LN] -> the engine's vector
        layout on the device."""
        if self._packed:
            return torch.from_numpy(self._pairs_permute(re, im)).to(
                self.device)
        if self._panel:
            return self._upload(self._layout.pack_x(re),
                                self._layout.pack_x(im))
        return self._upload(re, im)

    def _unpack_x(self, x_engine) -> tuple:
        """The engine's vector layout -> X-shaped host planes
        (re, im) [nnzbX, LM, LN]."""
        if self._packed:
            return self._pairs_unpermute(x_engine.cpu().numpy())
        re, im = (t.cpu().numpy() for t in x_engine)
        if self._panel:
            return self._layout.unpack_x(re), self._layout.unpack_x(im)
        return re, im

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
            # per-(column, RHS) squared norms of B, float64 on the host as
            # in the JAX package (its solver.py:694-700): the normalization
            # of restarts and of the refinement rounds
            cols_b = self.plan.colindx[self.plan.subset].cpu().numpy()
            bn2 = np.zeros((self.plan.ncols, self.ln))
            np.add.at(bn2, cols_b.astype(np.int64),
                      (re.astype(np.float64) ** 2
                       + im.astype(np.float64) ** 2).sum(axis=1))
            self._bn2 = bn2
        else:
            # initial guess X0: solve A*dX == B - A*X0 and return X0 + dX
            # (the reference always starts from zero, tfqmrgpu_core.hxx:125)
            self._x0 = self._upload_x(re, im)

    def _make_multiply(self, re: np.ndarray, im: np.ndarray):
        """The engine's y = A @ x over A's (re, im) block planes.  K2 runs
        ``pairs_prec``; K3 runs TFQ_PALLAS_MM_PREC (default 'highest'), read
        here as the JAX package's ``bsr_panel_multiply`` reads it when it
        builds the multiply.  The float64 engines take the Ozaki opt-ins
        TFQ_XLA_OZ and TFQ_Z_OZAKI (``ops/ozaki.py``)."""
        if self.engine == "dense":
            lay = self._layout
            a_re, a_im = self._upload(*lay.densify_a(self.plan, re, im))
            mask4 = torch.from_numpy(lay.mask[:, None, :, None]).to(
                self.device, self.dtype)
            return panel_ops.dense_multiply(a_re, a_im, mask4, lay.mb,
                                            lay.lm, lay.ncc, lay.ln)
        a_re, a_im = self._upload(re, im)
        if self._packed:
            if self._sup is not None:     # fine A blocks into merged cells
                a_re = sb_ops.merge_a_blocks(self._sup, a_re)
                a_im = sb_ops.merge_a_blocks(self._sup, a_im)
            if self._z_oz:
                return oz_multiply(self._pp_plan, a_re, a_im)
            return pp_ops.PairPanelMultiply(
                self._pp_plan,
                pp_ops.build_a_panels_device(self._pp_plan, a_re, a_im),
                precision=self.pairs_prec)
        if self.engine == "pallas":
            return RowTileMultiply(
                self._pack, build_a_panels_device(self._pack, a_re),
                build_a_panels_device(self._pack, a_im), self._layout.mask,
                self.ln,
                precision=os.environ.get("TFQ_PALLAS_MM_PREC") or "highest")
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
        re, im = self._unpack_x(self._x_result)
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
        with trace(f"tfq.solve.{self.engine}", self.device):
            if self._x0 is not None and not rhs_trivial:
                result = self._solve_shifted(tolerance, max_iterations)
            elif self._panel:
                result = self._solve_panel(tolerance, max_iterations,
                                           rhs_trivial)
            elif self._packed:
                result = self._solve_fused(tolerance, max_iterations,
                                           rhs_trivial)
            else:
                result = self._solve_blocks(tolerance, max_iterations,
                                            rhs_trivial)
        return self._finish_solve(result, max_iterations)

    def _solve_blocks(self, tolerance, max_iterations, rhs_trivial):
        """The block-list engines ('pairs' in 'z', 'xla')."""
        b = self._b
        if b is None:          # trivial RHS: a shape placeholder
            z = torch.zeros((self.plan.nnzb_b, self.lm, self.ln),
                            dtype=self.dtype, device=self.device)
            b = (z, z)
        return core.solve_core(self._multiply, b, self._v3, self._cols,
                               self.plan.subset, tolerance, max_iterations,
                               rhs_trivial=rhs_trivial, lm=self.lm,
                               ln=self.ln)

    def _solve_panel(self, tolerance, max_iterations, rhs_trivial):
        """The panel engines ('dense', 'pallas'), as the JAX package's
        _solve_panel."""
        if rhs_trivial:
            lay = self._layout
            npdt = np.float64 if self.dtype == torch.float64 else np.float32
            unit = lay.unit_b_blocks(npdt)
            b = self._upload(lay.pack_b(unit), lay.pack_b(np.zeros_like(unit)))
        else:
            b = self._b
        return core.solve_core_panel(self._multiply, b, self._v3, tolerance,
                                     max_iterations, rhs_trivial=rhs_trivial)

    def _fused_primitives(self, b: torch.Tensor) -> core.TfqmrPrimitives:
        return pp_ops.fused_primitives(self._multiply, self._pp_plan,
                                       self.plan.ncols, b, self._gp,
                                       sup_mask=self._sup_mask)

    def _solve_fused(self, tolerance, max_iterations, rhs_trivial):
        """The packed 'pairs' engine, as the JAX package's _solve_pairs."""
        if rhs_trivial:
            unit = linalg.set_unit_blocks(self.plan.nnzb_b, self.lm, self.ln,
                                          self.dtype)[0].numpy()
            b = self._pairs_b_panel(unit, np.zeros_like(unit))
        else:
            b = self._b
        return core.solve_core_fused(self._fused_primitives(b), b, self._v3,
                                     self.plan.ncols, self.ln, tolerance,
                                     max_iterations, rhs_trivial=rhs_trivial)

    def _solve_x(self, b, tolerance, max_iterations, inv_bn2):
        """Solve A @ dX == b for an X-shaped ``b`` in the engine's vector
        layout, with the convergence normalization ``inv_bn2`` [ncols, LN]
        (float64 on the device)."""
        if self._panel:
            return core.solve_core_panel(self._multiply, b, self._v3,
                                         tolerance, max_iterations, inv_bn2)
        if self._packed:
            return core.solve_core_fused(self._fused_primitives(b), b,
                                         self._v3, self.plan.ncols, self.ln,
                                         tolerance, max_iterations, inv_bn2)
        ident = torch.arange(self.plan.nnzb_x, dtype=torch.int32,
                             device=self.device)
        return core.solve_core(self._multiply, b, self._v3, self._cols, ident,
                               tolerance, max_iterations, inv_bn2,
                               lm=self.lm, ln=self.ln)

    def _solve_shifted(self, tolerance, max_iterations):
        """The restart from the initial guess X0, as the JAX package's
        _solve_shifted: solve A @ dX == B - A @ X0, with the convergence
        target relative to the original |B|, and return X0 + dX."""
        x0 = self._x0
        inv = core.inverse_norms(torch.from_numpy(self._bn2).to(self.device))
        if self._packed:
            b = self._b - self._fused_primitives(self._b).multiply(x0)
            result = self._solve_x(b, tolerance, max_iterations, inv)
            return result._replace(x=result.x + x0)
        bx = self._b                  # the panels hold B in X's shape
        if not self._panel:
            z = torch.zeros_like(x0[0])
            bx = linalg.add_rhs((z, z), self._b, 1.0, self.plan.subset)
        ax0 = self._multiply(x0)
        result = self._solve_x((bx[0] - ax0[0], bx[1] - ax0[1]), tolerance,
                               max_iterations, inv)
        return result._replace(x=(result.x[0] + x0[0], result.x[1] + x0[1]))

    def _solve_xshaped(self, r, inv_bn2, tolerance: float,
                       max_iterations: int) -> core.SolveResult:
        """Solve A @ dX == r for an X-shaped right-hand side ``r`` (the
        correction step of iterative refinement): (re, im) planes
        [nnzbX, LM, LN], tensors or arrays, in any precision; ``inv_bn2``
        [ncols, LN] replaces the normalization by |r|.  Returns the raw
        ``SolveResult`` (x in the engine's layout) and leaves the solver's
        stored result alone."""
        if self._panel or self._packed:
            # the layout change runs on the host, as set_matrix('X') does
            npdt = np.float64 if self.dtype == torch.float64 else np.float32
            b = self._upload_x(*(np.ascontiguousarray(
                v.to(self.dtype).cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v, dtype=npdt)) for v in r))
        else:
            b = tuple(torch.as_tensor(v).to(self.device, self.dtype)
                      .contiguous() for v in r)
        inv = torch.as_tensor(inv_bn2).to(self.device, torch.float64)
        return self._solve_x(b, tolerance, max_iterations, inv)

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
            # the fine plan's count, merged or not (JAX: solver.py:1030-1033)
            per_iter = core.flops_per_iteration(p.n_pairs, p.nnzb_x,
                                                self.lm, self.ln)
            per_probe = core.flops_per_probe(p.n_pairs, p.nnzb_x, self.lm,
                                             self.ln)
        flops = iters * per_iter + result.n_probes * per_probe
        p.residuum_reached = result.residuum
        p.iterations_needed = iters
        p.flops_performed = flops
        p.flops_performed_all += flops
        self._info = SolveInfo(
            residuum_reached=result.residuum, iterations_needed=iters,
            flops_performed=flops, flops_performed_all=p.flops_performed_all,
            return_status=result.return_status,
            rhs_status=result.rhs_status.cpu().numpy(),
            n_probes=result.n_probes, engine=self.engine)
        return self._info

    def solve_checkpointed(self, tolerance: float = 1e-6,
                           max_iterations: int = 999, chunk: int = 50,
                           state_path: Optional[str] = None) -> SolveInfo:
        """Chunked solve with restart-based checkpointing, as the JAX
        package's (its solver.py:1077-1133).

        Runs chunks of ``chunk`` iterations; after each chunk the iterate X
        is saved to ``state_path`` (``.npz``: ``x_re``, ``x_im``,
        ``iterations``), if given, and installed as the initial guess of the
        next chunk.  A call with the same ``state_path`` resumes from the
        file; on success the file is removed.  A restart drops the Krylov
        space, so the total can exceed an uninterrupted solve's.  The
        convergence target stays relative to the original |B|.  The last
        chunk's initial guess stays installed (``clear_initial_guess`` drops
        it)."""
        if state_path and not state_path.endswith(".npz"):
            state_path += ".npz"      # np.savez appends it
        if state_path and os.path.exists(state_path):
            with np.load(state_path) as st:
                self.set_matrix("X", st["x_re"] + 1j * st["x_im"])
                done = int(st["iterations"])
        else:
            done = 0
        if done >= max_iterations:
            self._info = SolveInfo(
                residuum_reached=float("nan"), iterations_needed=done,
                flops_performed=0.0,
                flops_performed_all=self.plan.flops_performed_all,
                return_status=int(Status.MAX_ITERATIONS), engine=self.engine)
            return self._info
        total = done
        info = None
        flops_total = 0.0
        while total < max_iterations:
            it = min(chunk, max_iterations - total)
            info = self.solve(tolerance=tolerance, max_iterations=it)
            total += info.iterations_needed if info.return_status == 0 else it
            flops_total += info.flops_performed
            x = self.get_matrix("X")
            if state_path:
                np.savez(state_path, x_re=x.real, x_im=x.imag,
                         iterations=total)
            if info.return_status == int(Status.SUCCESS):
                break
            self.set_matrix("X", x)
        if info is not None:
            info.iterations_needed = total
            info.flops_performed = flops_total
            if (state_path and info.return_status == int(Status.SUCCESS)
                    and os.path.exists(state_path)):
                os.remove(state_path)
        return info

    def clear_initial_guess(self):
        """Drop the initial guess X0: the next solve starts from zero, as
        the reference's always does (tfqmrgpu_core.hxx:125)."""
        self._x0 = None

    def get_info(self) -> SolveInfo:
        """The last solve's statistics (getInfo, tfqmrgpu.cu:663-679)."""
        if self._info is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "solve() has not been called")
        return self._info


# ------------------------------------------------------------- one-callers

def refine_mixed(sc: Solver, a_re64: np.ndarray, a_im64: np.ndarray,
                 bx64: np.ndarray, tolerance: float, max_iterations: int,
                 info_c: SolveInfo, echo: int = 0, max_rounds: int = 12):
    """Mixed-precision iterative refinement over a 'c' Solver that has
    solved once (JAX: its solver.py:1151-1217).

    Each round measures the float64 residual B - A @ X with the pair-plan
    product over the plan in float64 (``PairPlanMultiply``: K1 on the card,
    the plain ``spmm_pairs`` on the CPU) and solves the correction
    A @ dX == r with the 'c' solver (``refine.refinement_loop``).

    Args:
      sc: the 'c' Solver; its iterate is the start.
      a_re64, a_im64: float64 planes of A [nnzbA, LM, LM].
      bx64: B scattered into X's shape, complex128 [nnzbX, LM, LN].
      info_c: the c stage's SolveInfo (the accounting's base).

    Returns (X complex128 [nnzbX, LM, LN], SolveInfo, converged).
    """
    from .refine import refinement_loop

    plan, dev, f64 = sc.plan, sc.device, torch.float64
    if sc._bn2 is None:
        raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                            "matrix 'B' has not been set")
    apply = pp_ops.PairPlanMultiply(
        plan, *(torch.from_numpy(np.ascontiguousarray(v, np.float64)).to(dev)
                for v in (a_re64, a_im64)), sc.ln)

    def correction(r, res2, stall, inner_max):
        result = sc._solve_xshaped(r, core.inverse_norms(res2), stall,
                                   inner_max)
        dx = result.x
        if sc._panel or sc._packed:
            dx = tuple(torch.from_numpy(v).to(dev) for v in sc._unpack_x(dx))
        inner = (result.iterations
                 if result.return_status == int(Status.SUCCESS)
                 else inner_max)
        return (dx[0].to(f64), dx[1].to(f64)), inner

    res = refinement_loop(
        apply64=lambda xr, xi: apply((xr, xi)), bx64=bx64,
        colindx=plan.colindx, bn2=sc._bn2,
        x0=sc.get_matrix("X").astype(np.complex128), tolerance=tolerance,
        max_iterations=max_iterations, total_iters=info_c.iterations_needed,
        inner_base=info_c.iterations_needed, solve_correction=correction,
        stall_seed=info_c.residuum_reached,
        flops_per_round=core.flops_per_probe(plan.n_pairs, plan.nnzb_x,
                                             sc.lm, sc.ln),
        flops_per_iteration=core.flops_per_iteration(
            plan.n_pairs, plan.nnzb_x, sc.lm, sc.ln),
        echo=echo, max_rounds=max_rounds, label="refine", device=dev)
    info = SolveInfo(
        residuum_reached=res["ratio"], iterations_needed=res["total_iters"],
        flops_performed=info_c.flops_performed + res["flops"],
        flops_performed_all=plan.flops_performed_all,
        return_status=int(Status.SUCCESS) if res["converged"]
        else int(Status.MAX_ITERATIONS), engine=sc.engine,
        refinement=dict(c_engine=sc.engine,
                        c_iterations=info_c.iterations_needed,
                        c_residuum=info_c.residuum_reached,
                        rounds=res["rounds"], iterations=res["total_iters"],
                        fallback=False))
    return res["x"], info, res["converged"]


def _scatter_to_x(plan, b_data: np.ndarray, lm: int, ln: int) -> np.ndarray:
    """B blocks [nnzbB, LM, LN] -> X-shaped complex128 [nnzbX, LM, LN]."""
    bx = np.zeros((plan.nnzb_x, lm, ln), np.complex128)
    np.add.at(bx, plan.subset.cpu().numpy().astype(np.int64),
              np.asarray(b_data, np.complex128))
    return bx


def solve_mixed(a: Bsr, x: Bsr, b: Bsr, *, tolerance: float = 1e-9,
                max_iterations: int = 999, c_tolerance: float = 1e-4,
                engine: str = "auto", index_offset: int = 0, echo: int = 0,
                device=None) -> tuple[Bsr, SolveInfo]:
    """Mixed precision ('m'), as the JAX package's ``solve_mixed``: a
    complex64 solve (to ``c_tolerance``, at most max(150,
    max_iterations // 4) iterations), then iterative refinement against a
    float64 residual (``refine_mixed``), and, only if refinement stalls
    within the budget, a complex128 solve restarted from the refined
    iterate.  The reference declares this mode and disables it
    (tfqmrgpu.cu:42).

    One difference is kept on purpose: the JAX fallback maps an explicit
    'pairs' or 'pallas' engine to 'dense', since its 'pairs' 'z' needed
    LM >= 16; here only 'pallas' (float32-only) maps to 'dense', and 'pairs'
    stays, since K1 runs 'z' at every block size."""
    sc = Solver(a, x, b, precision="c", engine=engine,
                index_offset=index_offset, echo=echo, device=device)
    a_re64 = np.ascontiguousarray(a.data.real, dtype=np.float64)
    a_im64 = np.ascontiguousarray(a.data.imag, dtype=np.float64)
    bx64 = _scatter_to_x(sc.plan, b.data, sc.lm, sc.ln)
    xm, info = mixed_stages(
        sc, a_re64, a_im64, bx64, tolerance=tolerance,
        max_iterations=max_iterations, c_tolerance=c_tolerance,
        make_z=lambda: Solver(a, x, b, precision="z",
                              engine="dense" if engine == "pallas" else engine,
                              index_offset=index_offset, echo=echo,
                              device=device),
        echo=echo)
    return x.with_data(xm), info


def mixed_stages(sc: Solver, a_re64: np.ndarray, a_im64: np.ndarray,
                 bx64: np.ndarray, *, tolerance: float, max_iterations: int,
                 c_tolerance: float, make_z, echo: int = 0):
    """The stages of 'm' over a built 'c' Solver ``sc`` that holds A and
    B: a complex64 solve (to ``c_tolerance``, at most max(150,
    max_iterations // 4) iterations), refinement against a float64
    residual (``refine_mixed``; the arguments are its), and, only if
    refinement stalls within the budget, a complex128 solve restarted from
    the refined iterate on the 'z' Solver that ``make_z()`` returns with A
    and B set.  Shared by ``solve_mixed`` and the plan API.

    Returns (X complex128 [nnzbX, LM, LN], SolveInfo)."""
    # when float32 stalls above c_tolerance, more c iterations are waste:
    # the refinement needs only a decent start
    maxit_c = min(max_iterations, max(150, max_iterations // 4))
    info_c = sc.solve(tolerance=max(c_tolerance, tolerance),
                      max_iterations=maxit_c)
    xm, info, converged = refine_mixed(sc, a_re64, a_im64, bx64, tolerance,
                                       max_iterations, info_c, echo=echo)
    if echo > 0:
        print(f"# mixed: {info_c.iterations_needed} c-iterations + "
              f"{info.iterations_needed - info_c.iterations_needed} "
              f"refine-iterations -> residuum {info.residuum_reached:.3e}"
              f"{'' if converged else ' (stalled)'}")
    if converged or info.iterations_needed >= max_iterations:
        return xm, info
    sz = make_z()
    sz.set_matrix("X", xm)
    info_z = sz.solve(tolerance=tolerance,
                      max_iterations=max_iterations - info.iterations_needed)
    info_z.iterations_needed += info.iterations_needed
    info_z.flops_performed += info.flops_performed
    info_z.refinement = dict(info.refinement, fallback=True)
    return sz.get_matrix("X"), info_z


def solve(a: Bsr, x: Bsr, b: Bsr, *, precision: str = "z",
          tolerance: float = 1e-6, max_iterations: int = 999,
          engine: str = "auto", index_offset: int = 0, echo: int = 0,
          device=None) -> tuple[Bsr, SolveInfo]:
    """One-call solve: returns (X with data attached, SolveInfo)
    (tfqmrgpu_bsrsv, tfqmrgpu.cu:700-791), on the CUDA card unless
    ``device`` is given.  precision 'm' runs ``solve_mixed``."""
    if precision == "m":
        return solve_mixed(a, x, b, tolerance=tolerance,
                           max_iterations=max_iterations, engine=engine,
                           index_offset=index_offset, echo=echo,
                           device=device)
    s = Solver(a, x, b, precision=precision, engine=engine,
               index_offset=index_offset, echo=echo, device=device)
    info = s.solve(tolerance=tolerance, max_iterations=max_iterations)
    return x.with_data(s.get_matrix("X")), info


def bsrsv(a: Bsr, x: Bsr, b: Bsr, **kw) -> tuple[Bsr, SolveInfo]:
    """The one-call solve in 'z' (default), 'c' or 'm' (tfqmrgpu_bsrsv,
    tfqmrgpu.cu:700-791); the keywords are ``solve``'s."""
    return solve(a, x, b, **kw)


def bsrsv_z(a, x, b, **kw):
    """complex128 one-call solve (tfqmrgpu_bsrsv_z, tfqmrgpu.cu:796-809)."""
    kw.setdefault("precision", "z")
    return bsrsv(a, x, b, **kw)


def bsrsv_c(a, x, b, **kw):
    """complex64 one-call solve (tfqmrgpu_bsrsv_c, tfqmrgpu.cu:812-822)."""
    kw.setdefault("precision", "c")
    return bsrsv(a, x, b, **kw)


def bsrsv_m(a, x, b, **kw):
    """Mixed-precision one-call solve: complex64 iterations refined against
    a float64 residual (the reference's declared, disabled 'm' mode,
    tfqmrgpu.cu:42)."""
    kw.setdefault("precision", "m")
    return bsrsv(a, x, b, **kw)

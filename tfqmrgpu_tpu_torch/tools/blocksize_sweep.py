"""The card's per-block-size tune table: K2, K3 and K1 at the reference's
15 block sizes on the golden-class plan, on one CUDA card.

    python3 -m tfqmrgpu_tpu_torch.tools.blocksize_sweep [out.json]

Counterpart of the JAX package's ``tools/blocksize_sweep.py`` and
``tools/make_tune_table.py``, and of the reference's hand-made TUNE table
(bench_tfqmrgpu.cu:529-547).  For every (LM, LN) pair of
allowed_block_sizes.h:4-18 on the golden-class pattern (281 block rows, 11
blocks a row, X full over 16 block columns; 49,456 pairs) with cos/sin data
(fill_cos_sin, bench_tfqmrgpu.cu:276-287) it runs

* K2 (the packed pairs, ``PairPanelMultiply``) in 'c' at the column group
  size ``solver.choose_group_size`` picks, r_tile 1;
* K3 (the row tiles, ``RowTileMultiply``) in 'c' at the r_tile of
  ``pallas_spmm.choose_row_tile``;
* K1 (the pair plan, ``PairPlanMultiply``) in 'z';
* the oz kernel (``OzPairPanelMultiply``, the packed 'z' route of
  TFQ_PAIRS_Z_OZ) in its solver's default mode ('xi8', or the mixed
  int8-A / bf16-X body where LM % 32 != 0) over the packed plan at the
  column group size of the 'z' rule (at most 256 lanes), r_tile 1, the
  whole multiply (X slicing, kernel and float64 combine) timed, at the
  sizes ``OZ_SIZES`` only: the merged LM' 16 and 32 at (LM', max(LM',
  32)) and the unmerged baselines (4, 4) and (8, 8) that ``ops/rates.py``
  reads;

holds each, mapped back to the fine blocks, against the float64 pair
product of the same data (the JAX bench's gate, its bench.py:1420-1445,
after bench_tfqmrgpu.cu:414: maxdev relative to the largest entry
<= 1e-4 in 'c' and <= 1e-12 in 'z'; the same bits on a repeated launch;
the oz rows relative to the largest entry of |A|.|X|, the Ozaki scheme's
error scale: its X slices carry 2^-49 of each entry, and at (16, 32) the
cos/sin product cancels to 0.059 of terms up to 176, so a float64-quality
product sits at 1.8e-12 of the largest entry there; an oz row also
equals its plain version to the bit, the kernel being exact),
prints its distance from its plain version beside it, times it with CUDA
events around ``reps`` calls queued back to back behind a spin kernel
(the kernel's device time, without host dispatch), and computes
TFlop/s by the reference's count, 8*LM*LM*LN a pair
(bench_tfqmrgpu.cu:335).  It writes ``build/blocksize_sweep.json`` (or
``out.json``) and prints the table in Markdown.  Everything runs in this
process; a shape that fails its check fails the sweep (after the table is
printed), and a kernel that does not build or launch raises at once.

``ops/rates.py`` takes K2's rates ('c') and the oz kernel's ('z') from
this table (``rates_from``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

GATES = {"c": 1e-4, "z": 1e-12}
REPS = 20
# the sizes of the oz kernel's rows: what ops/rates.py reads for 'z'
OZ_SIZES = ((4, 4), (8, 8), (16, 32), (32, 32))


def golden_class_patterns(mb: int = 281, deg: int = 11, ncols: int = 16):
    """The banded plan the JAX package's bench.py:63-86 synthesizes when the
    golden asset is absent (49,456 pairs at the defaults): A's row i holds
    block columns i .. i+deg-1 (mod mb), X is full over ncols block columns,
    and B holds the blocks (j, j)."""
    from ..bsr import Bsr

    colind_a = ((np.arange(mb)[:, None] + np.arange(deg)[None, :])
                % mb).reshape(-1)
    a = Bsr(mb, mb, np.arange(mb + 1) * deg, colind_a, None, "A")
    x = Bsr(mb, ncols, np.arange(mb + 1) * ncols,
            np.tile(np.arange(ncols), mb), None, "X")
    b = Bsr(mb, ncols, np.minimum(np.arange(mb + 1), ncols),
            np.arange(ncols), None, "B")
    return a, x, b


def cos_sin(nnzb: int, d1: int, d2: int) -> np.ndarray:
    """re = cos(idx), im = sin(idx), idx = (m*d1 + i)*d2 + j
    (fill_cos_sin, bench_tfqmrgpu.cu:276-287)."""
    idx = np.arange(nnzb * d1 * d2, dtype=np.float64).reshape(nnzb, d1, d2)
    return np.cos(idx) + 1j * np.sin(idx)


def _planes(c: np.ndarray, dtype, device) -> tuple:
    return (torch.from_numpy(np.ascontiguousarray(c.real)).to(device, dtype),
            torch.from_numpy(np.ascontiguousarray(c.imag)).to(device, dtype))


def _maxdev(got, want) -> float:
    """max |got - want| over the largest |want|, over (re, im) pairs of
    tensors or arrays."""
    dev = max(float(abs(g - w).max()) for g, w in zip(got, want))
    return dev / max(float(abs(w).max()) for w in want)


# cycles the stream spins before a timed burst (about 30 ms on an H100):
# longer than the host takes to queue the burst, so that the events time
# the kernels back to back and no host dispatch between them
SPIN_CYCLES = 50_000_000


def time_ms(fn, device, reps: int = REPS, warm: int = 3) -> float:
    """Device milliseconds a call: CUDA events around ``reps`` calls issued
    back to back after ``warm`` calls, queued behind a spin kernel
    (``torch.cuda._sleep``) so that the burst runs on the card without the
    host's dispatch gaps (a small kernel here takes less time than its
    launch takes on the host).  The host clock on the CPU."""
    for _ in range(warm):
        fn()
    if device.type != "cuda":
        from ..profiling import _timed

        return _timed(lambda: [fn() for _ in range(reps)],
                      device)[1] * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Each maker returns (call, plain, to_fine, what): the kernel's call and its
# plain version on the same inputs, the map of their output to the fine
# (re, im) blocks [nnzbX, LM, LN] on the host, and what was picked.

def _k2(plan, lm, ln, av, xv, device):
    """K2 at the rule's G."""
    from ..ops import pairpanel as pp
    from ..solver import pack_pairs

    gp, pplan = pack_pairs(plan, lm, ln, group_size=0, r_tile=1)
    xre, xim = (np.ascontiguousarray(v, dtype=np.float32)
                for v in (xv.real, xv.imag))
    if gp is not None:
        xre, xim = pp.grouped_blocks(gp, xre), pp.grouped_blocks(gp, xim)
    mult = pp.PairPanelMultiply(pplan, pp.build_a_panels_device(
        pplan, *_planes(av, torch.float32, device)))
    x = torch.from_numpy(pp.permute_x(pplan, xre, xim)).to(device)

    def to_fine(y):
        re, im = pp.unpermute_y(pplan, y[0].cpu().numpy())
        if gp is not None:
            re, im = pp.ungroup_blocks(gp, re), pp.ungroup_blocks(gp, im)
        return re, im

    return (lambda: (mult(x),)), (lambda: (mult.plain(x),)), to_fine, dict(
        group=gp.group_size if gp is not None else 1, ntiles=pplan.ntiles,
        ku=pplan.ku)


def _k3(plan, lm, ln, av, xv, device):
    """K3 at the model's r_tile."""
    from ..ops.pallas_spmm import (RowTileMultiply, build_a_panels_device,
                                   choose_row_tile)
    from ..ops.panel import PanelLayout

    lay = PanelLayout.from_plan(plan)
    xp = tuple(torch.from_numpy(lay.pack_x(np.ascontiguousarray(v))).to(
        device, torch.float32) for v in (xv.real, xv.imag))
    pack = choose_row_tile(plan, lm)
    a_re, a_im = _planes(av, torch.float32, device)
    mult = RowTileMultiply(pack, build_a_panels_device(pack, a_re),
                           build_a_panels_device(pack, a_im), lay.mask, ln)

    def to_fine(y):
        return tuple(lay.unpack_x(v.cpu().numpy()) for v in y)

    return (lambda: mult(xp)), (lambda: mult.plain(xp)), to_fine, dict(
        r_tile=pack.r_tile, ntiles=pack.ntiles, ku=pack.ku)


def _k1(plan, lm, ln, av, xv, device):
    """K1 in 'z' on the plan's tile schedule."""
    from ..ops.pairpanel import PairPlanMultiply

    mult = PairPlanMultiply(plan, *_planes(av, torch.float64, device), ln)
    xp = _planes(xv, torch.float64, device)
    s = mult.schedule
    return (lambda: mult(xp)), (lambda: mult.plain(xp)), (
        lambda y: tuple(v.cpu().numpy() for v in y)), dict(
        tile=f"{s.rows} x {s.cols}" if s is not None else None)


def _oz(plan, lm, ln, av, xv, device):
    """The oz kernel's whole 'z' multiply over the packed plan."""
    from ..ops import pairpanel as pp
    from ..solver import Z_GROUP_LANE_LIMIT, oz_multiply, pack_pairs

    gp, pplan = pack_pairs(plan, lm, ln, group_size=0, r_tile=1,
                           lane_limit=Z_GROUP_LANE_LIMIT)
    xre, xim = np.ascontiguousarray(xv.real), np.ascontiguousarray(xv.imag)
    if gp is not None:
        xre, xim = pp.grouped_blocks(gp, xre), pp.grouped_blocks(gp, xim)
    mult = oz_multiply(pplan, *_planes(av, torch.float64, device))
    x = torch.from_numpy(pp.permute_x(pplan, xre, xim)).to(device)

    def to_fine(y):
        re, im = pp.unpermute_y(pplan, y[0].cpu().numpy())
        if gp is not None:
            re, im = pp.ungroup_blocks(gp, re), pp.ungroup_blocks(gp, im)
        return re, im

    return (lambda: (mult(x),)), (lambda: (mult.plain(x),)), to_fine, dict(
        group=gp.group_size if gp is not None else 1, ntiles=pplan.ntiles,
        ku=pplan.ku, body=mult.body, p=mult.p)


KERNELS = (("K2", "c", _k2), ("K3", "c", _k3), ("K1", "z", _k1),
           ("OZ", "z", _oz))


def sweep(device, sizes=None, mb: int = 281, deg: int = 11, ncols: int = 16,
          reps: int = REPS, echo=print) -> list:
    """One row per (LM, LN) of ``sizes`` (the 15 allowed pairs by default)
    and kernel: the check against the plain version and the time.  On a
    CPU device the wrappers run their plain versions, and the times are
    the host's."""
    from .. import ALLOWED_BLOCK_SIZES
    from ..ops.blocksparse import spmm_pairs
    from ..plan import create_plan

    device = torch.device(device)
    a, x, b = golden_class_patterns(mb, deg, ncols)
    plan = create_plan(a, x, b, device=device)
    rows = []
    for lm, ln in sizes or ALLOWED_BLOCK_SIZES:
        plan.lm, plan.ln = lm, ln
        av, xv = cos_sin(plan.nnzb_a, lm, lm), cos_sin(plan.nnzb_x, lm, ln)
        flops = plan.n_pairs * 8.0 * lm * lm * ln
        ref = tuple(v.cpu().numpy() for v in spmm_pairs(
            _planes(av, torch.float64, device),
            _planes(xv, torch.float64, device), plan.pairs[:, 0],
            plan.pairs[:, 1], plan.pair_y(), plan.nnzb_x))
        terms = None                     # max of |A|.|X|, for the oz rows
        for name, prec, make in KERNELS:
            if name == "OZ" and (lm, ln) not in OZ_SIZES:
                continue
            call, plain, to_fine, info = make(plan, lm, ln, av, xv, device)
            got = call()
            again = call()
            maxdev = _maxdev(to_fine(got), ref)
            maxdev_plain = _maxdev(got, plain())
            gated = maxdev
            if name == "OZ":
                if terms is None:
                    zero = torch.zeros((plan.nnzb_a, lm, lm),
                                       dtype=torch.float64, device=device)
                    terms = float(spmm_pairs(
                        (torch.from_numpy(np.abs(av)).to(device), zero),
                        (torch.from_numpy(np.abs(xv)).to(device),
                         torch.zeros((plan.nnzb_x, lm, ln),
                                     dtype=torch.float64, device=device)),
                        plan.pairs[:, 0], plan.pairs[:, 1], plan.pair_y(),
                        plan.nnzb_x)[0].max())
                scale = max(float(abs(w).max()) for w in ref)
                gated = maxdev * scale / terms
                info = dict(info, maxdev_terms=gated)
            ms = time_ms(call, device, reps)
            row = dict(kernel=name, precision=prec, lm=lm, ln=ln, **info,
                       n_pairs=plan.n_pairs, maxdev=maxdev,
                       maxdev_plain=maxdev_plain, gate=GATES[prec],
                       gate_pass=bool(gated <= GATES[prec] and all(
                           torch.equal(p, q) for p, q in zip(got, again))
                           and (name != "OZ" or maxdev_plain == 0.0)),
                       ms=ms, tflops=flops / ms / 1e9)
            rows.append(row)
            if echo:
                echo(f"sweep {name} '{prec}' ({lm}, {ln}) {info}: "
                     f"{ms:.4f} ms, {row['tflops']:.3f} TFlop/s, maxdev "
                     f"{maxdev:.3e} (from the plain version "
                     f"{maxdev_plain:.3e})"
                     f"{'' if row['gate_pass'] else ' FAILED'}")
            del call, plain, got, again
    return rows


def rates_from(rows: list) -> tuple:
    """The rates as ``ops/rates.py`` holds them, in TFlop/s by precision:
    (ENGINE {precision: {16, 32}}, BASE {precision: {4, 8}}), K2's for 'c'
    and the oz kernel's for 'z'.  A merged problem at LM' widens its lanes
    toward max(LM', 32) (the solver's superblock), so ENGINE[LM'] is the
    rate at (LM', max(LM', 32)); the unmerged baseline is the square block
    (LM, LM)."""
    engine, base = {}, {}
    for prec, name in (("c", "K2"), ("z", "OZ")):
        k = {(r["lm"], r["ln"]): r["tflops"] for r in rows
             if r["kernel"] == name and r["gate_pass"]}
        engine[prec] = {m: k[(m, max(m, 32))] for m in (16, 32)
                        if (m, max(m, 32)) in k}
        base[prec] = {m: k[(m, m)] for m in (4, 8) if (m, m) in k}
    return engine, base


def markdown(rows: list, card: str = "") -> str:
    """The tune table: one line per (LM, LN), each kernel's TFlop/s and
    maxdev."""
    by = {}
    for r in rows:
        by.setdefault((r["lm"], r["ln"]), {})[r["kernel"]] = r
    head = ("| LM | LN | K2 'c' G | K2 TFlop/s | K2 maxdev | K3 'c' r_tile "
            "| K3 TFlop/s | K3 maxdev | K1 'z' TFlop/s | K1 maxdev "
            "| oz 'z' | oz TFlop/s | oz maxdev |")
    lines = ([f"Golden-class plan, {card}" if card else "Golden-class plan",
              "", head, "|" + "---|" * 13])
    for (lm, ln), d in sorted(by.items()):
        k2, k3, k1 = d["K2"], d["K3"], d["K1"]
        oz = d.get("OZ")
        oz_cols = (f"{oz['body']} G {oz['group']} | {oz['tflops']:.3f} | "
                   f"{oz['maxdev']:.1e}" if oz else "- | - | -")
        lines.append(
            f"| {lm} | {ln} | {k2['group']} | {k2['tflops']:.3f} | "
            f"{k2['maxdev']:.1e} | {k3['r_tile']} | {k3['tflops']:.3f} | "
            f"{k3['maxdev']:.1e} | {k1['tflops']:.3f} | {k1['maxdev']:.1e} | "
            f"{oz_cols} |")
    return "\n".join(lines)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("blocksize_sweep needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    rows = sweep(torch.device("cuda"),
                 echo=lambda s: print(s, flush=True))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = argv[1] if len(argv) > 1 else os.path.join(
        repo, "build", "blocksize_sweep.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    engine, base = rates_from(rows)
    with open(out, "w") as f:
        json.dump(dict(card=card, reps=REPS, rows=rows,
                       rates=dict(engine=engine, base=base)), f, indent=1)
    print(markdown(rows, card))
    print(f"rates (TFlop/s, K2 'c', oz 'z'): merged {engine}, unmerged "
          f"{base}; {out}")
    failed = [r for r in rows if not r["gate_pass"]]
    if failed:
        raise SystemExit(f"{len(failed)} shapes failed their check: "
                         + ", ".join(f"{r['kernel']} ({r['lm']}, {r['ln']})"
                                     for r in failed))


if __name__ == "__main__":
    main(sys.argv)

"""Per-iteration collective bytes of the sharded packed-pairs engine, and
their time at the H100's rates.

Counterpart of ``tfqmrgpu_tpu/parallel/comm_model.py``.  The byte counts
are geometry and equal the JAX package's for the same layout; the times
are the card's:

* the interconnect is NVLink 4 on an H100 SXM, 450 GB/s in each direction
  per card (NVIDIA's data sheet: 900 GB/s both ways together), until a
  four-card run measures it (``nvlink_bytes_per_s``);
* device memory streams at 3.35 TB/s (the data sheet; ``hbm_bytes_per_s``,
  or the stream probe K4's reading passed in);
* a shard's multiply takes the bound of K2 over its tiles, the larger of
  its bytes (A panels, the X blocks its tiles list, its Y rows and tables,
  each once) over the memory rate and its products (8*LM*LM*LN flops a
  pair of the plan) over 67 TFlop/s of FP32 (``fp32_flops_per_s``), as
  ``chip_smoke.bound`` counts it; or ``k2_ms``, a measured time per
  multiply, passed in.  The slowest shard sets the pace.

Per tfQMR iteration the loop runs 2 multiplies, 2 ``dotp`` and 2 ``nrm2``
(reference: tfqmrgpu_core.hxx:179-306); a probe adds one multiply and one
``nrm2`` on probe iterations only, which the model leaves out.

Collectives of ``ShardedPairsSolver.multiply``:

* neighbour halo: the two edge slabs of (h_lo + h_hi) blocks, bytes per
  shard constant in pr;
* ``all_gather``: the whole fused X panel each multiply, (pr-1) shard
  slabs received per shard;
* reductions: ``dotp`` (re and im) and ``nrm2`` partials [n_groups, LN']
  float32, priced as a ring all-reduce, 2*bytes*(pr-1)/pr per shard.

The local tiles run while the halo collective is in flight, so their share
of the multiply hides it; only the rest is exposed.  The model counts
bytes over rates only: the fixed latency of each collective call is not
in it.
"""

from __future__ import annotations

import numpy as np

from ..profiling import DEVICE_PEAKS, H100

NVLINK_BYTES_PER_S = 450e9      # NVLink 4, H100 SXM, one direction a card
HBM_BYTES_PER_S = DEVICE_PEAKS[H100]["hbm_gbps"] * 1e9
FP32_FLOPS_PER_S = DEVICE_PEAKS[H100]["fp32_tflops"] * 1e12
SPMM_PER_ITER = 2
PSUM_PLANES_PER_ITER = 6        # 2 dotp x 2 planes + 2 nrm2 x 1
VEC_PASSES_PER_ITER = 13        # the JAX model's vector passes an iteration
SOURCES = ("NVLink 4 450 GB/s a direction a card, HBM3 3.35 TB/s and FP32 "
           "67 TFlop/s: NVIDIA H100 SXM data sheet (700 W)")


def k2_shard_work(layout, s: int) -> tuple:
    """(bytes, flops) of shard ``s``'s K2 launches in one multiply: its A
    panels and tables, the distinct X blocks its tiles list, its Y rows,
    each once; the products of the plan's pairs it holds."""
    p0, t, lm = layout.pp_plan, layout.shards[s], layout.lm
    ids = np.concatenate([t.local, t.prefix, t.suffix])
    ids = ids[ids >= 0]
    lanes = 2 * layout.ln
    live = np.arange(p0.ku)[None, :] < p0.kcount[ids][:, None]
    x_blocks = np.unique(p0.xloc[ids][live]).shape[0]
    rlm = layout.r_tile * lm
    nbytes = 4 * (ids.shape[0] * (2 * rlm * p0.ku * lm + p0.ku)
                  + x_blocks * lm * lanes + layout.vrows_local * lanes)
    flops = 8.0 * lm * lm * layout.ln0 * float(layout.pairs_local[s])
    return nbytes, flops


def pairs_comm_report(layout, *, nvlink_bytes_per_s: float = NVLINK_BYTES_PER_S,
                      hbm_bytes_per_s: float = HBM_BYTES_PER_S,
                      fp32_flops_per_s: float = FP32_FLOPS_PER_S,
                      k2_ms: float = None) -> dict:
    """Collective bytes and modelled times per iteration of a
    ``ShardedPairsLayout``: per-shard bytes of each collective, the
    compute and link times, the share of the link time the local tiles
    hide, and the modelled parallel efficiency t_compute / (t_compute +
    t_link_exposed)."""
    lanes = 2 * layout.ln                   # fused re/im lanes
    el = 4                                  # float32 bytes
    shard_rows = layout.vrows_local
    pr = layout.pr
    if layout.halo:
        gather_bytes = (layout.h_lo + layout.h_hi) * layout.lm * lanes * el
        mode = "neighbour-halo (batch_isend_irecv edge slabs)"
        scalable = True
    elif layout.p + layout.q:
        gather_bytes = (pr - 1) * shard_rows * lanes * el
        mode = "all_gather (full panel)"
        scalable = False
    else:
        gather_bytes = 0
        mode = "none (all tiles shard-local)"
        scalable = True
    red_bytes = (PSUM_PLANES_PER_ITER * layout.n_oh * layout.ln * el
                 * 2 * (pr - 1) / max(pr, 1))
    iter_bytes = SPMM_PER_ITER * gather_bytes + red_bytes

    if k2_ms is None:
        t_mult = max(max(b / hbm_bytes_per_s, f / fp32_flops_per_s)
                     for b, f in (k2_shard_work(layout, s)
                                  for s in range(pr)))
    else:
        t_mult = float(k2_ms) * 1e-3
    # the fused vector work streams the shard's rows from device memory
    vec_s = VEC_PASSES_PER_ITER * 2 * shard_rows * lanes * el / hbm_bytes_per_s
    t_compute = SPMM_PER_ITER * t_mult + vec_s

    t_gather = SPMM_PER_ITER * gather_bytes / nvlink_bytes_per_s
    t_red = red_bytes / nvlink_bytes_per_s
    f_loc = layout.n_loc / max(layout.tiles_local, 1)
    hidden = f_loc * SPMM_PER_ITER * t_mult
    t_exposed = max(0.0, t_gather - hidden) + t_red
    eff = t_compute / (t_compute + t_exposed) if t_compute > 0 else 0.0
    return dict(
        mode=mode, pr=pr, weak_scalable=scalable,
        gather_bytes_per_multiply=int(gather_bytes),
        reduction_bytes_per_iteration=int(round(red_bytes)),
        collective_bytes_per_iteration=int(round(iter_bytes)),
        local_tile_fraction=round(f_loc, 4),
        t_multiply_ms=t_mult * 1e3,
        t_compute_ms=t_compute * 1e3,
        t_link_ms=(t_gather + t_red) * 1e3,
        t_link_exposed_ms=t_exposed * 1e3,
        modeled_efficiency=eff,
        assumptions=dict(
            nvlink_bytes_per_s=nvlink_bytes_per_s,
            hbm_bytes_per_s=hbm_bytes_per_s,
            fp32_flops_per_s=fp32_flops_per_s,
            k2="measured ms per multiply" if k2_ms is not None
            else "K2 bound of the slowest shard",
            spmm_per_iteration=SPMM_PER_ITER,
            psum_planes_per_iteration=PSUM_PLANES_PER_ITER,
            source=SOURCES,
            note="probe iterations (1 extra multiply + nrm2) and the "
                 "collectives' fixed latency left out"))


def weak_scaling_model(mb_per_shard: int = 561, lm: int = 32, ln: int = 32,
                       ncols: int = 1, halfband: int = 2,
                       prs=(1, 2, 4, 8, 16, 32), **rates) -> list:
    """Modelled weak-scaling curve: a banded problem grown with the shard
    count (mb = mb_per_shard * pr), laid out as ``ShardedPairsSolver``
    would lay it out (a real ``ShardedPairsLayout`` at every pr; no ranks
    needed), bytes and times from ``pairs_comm_report`` (``rates`` are
    its keyword arguments)."""
    from ..plan import create_plan
    from .scaling import _banded_problem
    from .sharded_pairs import ShardedPairsLayout

    rows = []
    for pr in prs:
        a, x, b = _banded_problem(mb_per_shard * pr, lm, ln, ncols,
                                  halfband=halfband)
        plan = create_plan(a, x, b, device="cpu")
        plan.lm, plan.ln = lm, ln
        rep = pairs_comm_report(ShardedPairsLayout(plan, pr), **rates)
        row = dict(pr=pr, mb=mb_per_shard * pr, measured_objects=True, **{
            k: rep[k] for k in (
                "mode", "weak_scalable", "gather_bytes_per_multiply",
                "reduction_bytes_per_iteration",
                "collective_bytes_per_iteration", "local_tile_fraction",
                "t_compute_ms", "t_link_exposed_ms", "modeled_efficiency")})
        row["efficiency_vs_pr1"] = (row["modeled_efficiency"]
                                    / (rows[0]["modeled_efficiency"] or 1.0)
                                    if rows else 1.0)
        rows.append(row)
    rows[0]["assumptions"] = dict(source=SOURCES, note=(
        "K2 bound of the slowest shard at those rates; probe iterations "
        "and the collectives' fixed latency left out; every row a real "
        "layout"))
    return rows


def main(argv=None):
    """``python -m tfqmrgpu_tpu_torch.parallel.comm_model [MB_PER_SHARD
    [LM]]``: one JSON row per shard count."""
    import json
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    mbs = int(argv[0]) if argv else 64
    lm = int(argv[1]) if len(argv) > 1 else 8
    for row in weak_scaling_model(mb_per_shard=mbs, lm=lm, ln=lm):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

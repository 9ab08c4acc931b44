"""Measured rates of the packed engine on the golden-class plan, K2 in 'c'
and the oz kernel in 'z': the one source of the superblock routing cost
model (``superblock.auto_f_row`` and the solver's superblock composition).

Counterpart of ``tfqmrgpu_tpu/ops/rates.py``, with the same interface and
the same defaults for sizes that were not measured; the values are the
card's, not the JAX package's.  The reference hard-wires a per-(LM, LN)
TUNE table measured on a V100 (bench_tfqmrgpu.cu:529-547); here routing
picks the merge factor that minimizes MAC inflation / rate.  A stale table
only mis-routes (the result stays exact).

Provenance: ``python3 -m tfqmrgpu_tpu_torch.tools.blocksize_sweep`` (also
``chip_smoke.py`` phase 19 (a)) on "NVIDIA H100 80GB HBM3, 700.00 W"
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``): K2's
TFlop/s by the reference's count (8*LM*LM*LN a pair), its device time from
CUDA events around 20 calls queued behind a spin kernel
(``blocksize_sweep.time_ms``), at the column group size the solver's rule
picks (8 at every size); ``blocksize_sweep.rates_from`` reads them off the
table: ``chip_smoke.py`` phase 19 (a) on that card, K2's device times
0.0114, 0.0337, 0.1213 and 0.3405 ms at (LM, LN) = (4, 4), (8, 8),
(16, 32) and (32, 32).

The 'z' rows are the oz kernel's (K1's Ozaki modes, ``csrc/pairpanel_oz.cu``)
whole 'z' multiply (X slicing, kernel, float64 combine) in the solver's
default mode ('xi8' at LM' 32, the mixed int8-A / bf16-X body at 16 and
below), at the column group size of the 'z' rule, from the same sweep's oz
rows: ``chip_smoke.py`` phase 19 (a) on "NVIDIA H100 80GB HBM3, 700.00 W",
1.5184, 1.9279, 3.2344 and 5.8142 ms at (4, 4), (8, 8), (16, 32) and
(32, 32).  Only the opt-in TFQ_PAIRS_Z_OZ=1 packs 'z' and reads them: by
default 'z' runs K1 on the plan's pair table and never merges.  The card's
peak rates are ``profiling.DEVICE_PEAKS``'s, not restated here.
"""

from __future__ import annotations

# K2's gate-passing TFlop/s at block edge LM' on the golden-class plan, at
# (LM', max(LM', 32)): the lanes a merged problem widens toward -- the
# rate a merged problem at LM' = lm2 runs at
ENGINE_TFLOPS = {
    "c": {16: 26.710, 32: 38.075},
    "z": {16: 1.002, 32: 2.230},
}

# K2's rates of the small sizes WITHOUT merging, at the square block
# (LM, LM): the do-nothing baseline the cost model must beat
BASE_TFLOPS = {
    "c": {4: 2.220, 8: 6.006},
    "z": {4: 0.017, 8: 0.105},
}


def engine_rate(precision: str, lm2: int) -> float:
    """Measured TFlop/s of the packed engine's kernel (K2 in 'c', the oz
    kernel in 'z') at merged block edge ``lm2`` (0.0 where the size or the
    precision was never measured: callers treat that as ineligible)."""
    return ENGINE_TFLOPS.get(precision, {}).get(lm2, 0.0)


def base_rate(precision: str, lm: int) -> float:
    """Measured unmerged rate at fine block edge ``lm`` (the pessimistic
    default, the least measured rate, for sizes not measured)."""
    t = BASE_TFLOPS.get(precision, BASE_TFLOPS["c"])
    return t.get(lm, min(t.values()))

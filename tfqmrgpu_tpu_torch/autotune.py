"""Runtime autotuning: the engine and its knobs raced on the caller's own
pattern.

Counterpart of ``tfqmrgpu_tpu/autotune.py``, which replaces the reference's
compile-time block-size registry and hand-made TUNE table (reference:
allowed_block_sizes.h, bench_tfqmrgpu.cu:529-547).  What is tunable here is
the engine ('dense', 'pallas' = the row tiles on K3, 'pairs' = K1 in 'z'
and the packed plan on K2 in 'c', 'xla') and the knobs those engines
really have, under the JAX package's names: TFQ_PALLAS_RTILE (K3's row
tile), TFQ_PAIRS_COLGROUP and TFQ_PAIRS_RTILE (K2's column groups and row
tile), and at LM <= 8 in 'c' TFQ_SOLVER_SUPER (the superblock row merge).

``autotune_solver`` measures candidates on the actual problem and returns
the fastest Solver.  As in the JAX package:

* the measured quantity is the isolated multiply (a chain of ``nrep``
  multiplies with varied inputs and one data-dependent host read), not a
  full solve, whose time is dominated by host dispatch and by where the
  residual probes fall;
* results persist to a JSON cache keyed on (pattern hash, LM, LN,
  precision, device kind), so a service pays the measurement once per
  operator pattern and card.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from .bsr import Bsr
from .errors import Status, TfqmrgpuError
from .profiling import _timed, device_kind
from .solver import GROUP_LANE_LIMIT, Solver


def _cache_path() -> str:
    """The cache file: ``autotune.json`` in TFQ_AUTOTUNE_CACHE, by default
    ``~/.cache/tfqmrgpu_tpu_torch`` (the port's own: a JAX entry is never
    read as the port's)."""
    d = os.environ.get("TFQ_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "tfqmrgpu_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "autotune.json")


def _pattern_key(plan, lm: int, ln: int, precision: str) -> str:
    """sha256 over the bytes the JAX package hashes: the pair list as
    uint32 and the compressed column indices as uint16 (its plan's types),
    then "lm:ln:precision:kind" with the card's name, or "cpu"."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(plan.pairs.cpu().numpy(),
                                  dtype=np.uint32).tobytes())
    h.update(np.ascontiguousarray(plan.colindx.cpu().numpy(),
                                  dtype=np.uint16).tobytes())
    h.update(f"{lm}:{ln}:{precision}:{device_kind(plan.pairs.device)}"
             .encode())
    return h.hexdigest()[:24]


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _store_cache(key: str, entry: dict) -> None:
    cache = _load_cache()
    cache[key] = entry
    try:
        with open(_cache_path(), "w") as f:
            json.dump(cache, f, indent=1)
    except OSError:
        pass


def multiply_chain(solver: Solver, nrep: int):
    """(chain, x0): ``chain(x)`` runs ``nrep`` multiplies of the solver's
    engine, each renormalized by max |y| (of the real plane), and returns
    the last vector; ``x0`` is the shadow vector v3 in the engine's layout
    and precision.  The packed engine's multiply is its solve's (K2, then
    the grouped lane mask), so the chain keeps zero what the solve keeps
    zero: absent lanes, and pad slots, whose A panels are zero."""
    if solver._multiply is None:
        raise RuntimeError("matrix 'A' has not been set")
    if solver._packed:
        multiply = solver._fused_primitives().multiply

        def step(x):
            y = multiply(x)
            return y * (1.0 / y.abs().max().clamp_min(1e-30))

        x0 = solver._v3
    else:
        multiply = solver._multiply

        def step(x):
            y = multiply(x)
            s = 1.0 / y[0].abs().max().clamp_min(1e-30)
            return y[0] * s, y[1] * s

        x0 = tuple(v.to(solver.dtype) for v in solver._v3)

    def chain(x):
        for _ in range(nrep):
            x = step(x)
        return x

    return chain, x0


def time_multiply(solver: Solver, nrep: int = 16, repeats: int = 2) -> float:
    """Best-of-``repeats`` time (s) of one multiply on the solver's engine:
    K1 ('pairs' 'z'), the oz kernel ('pairs' 'z' under TFQ_PAIRS_Z_OZ),
    K2 ('pairs' 'c'), K3 ('pallas'), four
    ``torch.matmul`` ('dense') or the plain block list ('xla').

    A chain of ``nrep`` multiplies (``multiply_chain``) runs on varied
    inputs (v3 * (1 + 0.01 i)) after a warm-up chain and ends in a
    data-dependent host read; on the card each chain and its read are timed
    by CUDA events, on the CPU by the host clock.  Returns the best chain
    over ``nrep``."""
    chain, x0 = multiply_chain(solver, nrep)
    scale = (lambda x, f: x * f) if torch.is_tensor(x0) else (
        lambda x, f: (x[0] * f, x[1] * f))
    xs = [scale(x0, 1.0 + 0.01 * i) for i in range(repeats + 1)]

    def first(x):
        return float((x if torch.is_tensor(x) else x[0]).reshape(-1)[0])

    first(chain(xs[-1]))                                 # warm-up
    best = min(_timed(lambda: first(chain(xs[i])), solver.device)[1]
               for i in range(repeats))
    return best / nrep


def default_candidates(precision: str, lm: int = 0) -> list:
    """(engine, env) candidates: the JAX package's list less the knobs the
    card's engines do not have.

    * 'c': at 0 < LM <= 8 first the superblock candidates, in the JAX
      list's order: 'pairs' with TFQ_SOLVER_SUPER=0 (the row merge off) and
      at each factor f in {16 // LM, 32 // LM} with f >= 2 (the routing
      cost model can misjudge an uncommon pattern); then 'dense'; 'pallas'
      at the model's r_tile and at TFQ_PALLAS_RTILE=1; 'pairs' at
      TFQ_PAIRS_RTILE=1 (model-picked column groups, and the superblock
      where 'auto' merges), with the groups off (TFQ_PAIRS_COLGROUP=1), and
      at TFQ_PAIRS_RTILE=2; 'xla'.  The JAX list's TFQ_PAIRS_TSTEP, _COPYG,
      _RESIDENT and _VMEM_CAP variants are the TPU's VMEM and scalar-core
      knobs, which the card does not have.
    * 'z': 'dense' (FP64 ``torch.matmul``), 'pairs' (K1, native FP64),
      then the JAX list's 'pairs' candidates, which run its packed route on
      the oz kernel, with TFQ_PAIRS_Z_OZ=1: the default ('xi8', or its
      fallback), TFQ_OZC_INT8=0 (bf16 X slices) and =1 (int8 A, bf16 X);
      'xla'; and at 0 < LM <= 8 the JAX list's TFQ_SOLVER_SUPER rows, with
      TFQ_PAIRS_Z_OZ=1 (the merge that lifts the oz kernel's LM to 16 or
      32; a candidate whose kernel LM stays below 16 is refused)."""
    if precision == "z":
        oz = {"TFQ_PAIRS_Z_OZ": "1"}
        sup = []
        if 0 < lm <= 8:
            sup = [("pairs", {**oz, "TFQ_SOLVER_SUPER": "0"})] + [
                ("pairs", {**oz, "TFQ_SOLVER_SUPER": str(f)})
                for f in sorted({16 // lm, 32 // lm}) if f >= 2]
        return [("dense", {}), ("pairs", {}), ("pairs", oz),
                ("pairs", {**oz, "TFQ_OZC_INT8": "0"}),
                ("pairs", {**oz, "TFQ_OZC_INT8": "1"}),
                ("xla", {})] + sup
    sup: list = []
    if 0 < lm <= 8:
        sup = [("pairs", {"TFQ_SOLVER_SUPER": "0"})] + [
            ("pairs", {"TFQ_SOLVER_SUPER": str(f)})
            for f in sorted({16 // lm, 32 // lm}) if f >= 2]
    return sup + [
        ("dense", {}),
        ("pallas", {}),                         # row tiles, model r_tile
        ("pallas", {"TFQ_PALLAS_RTILE": "1"}),
        ("pairs", {"TFQ_PAIRS_RTILE": "1"}),    # model-picked column groups
        ("pairs", {"TFQ_PAIRS_RTILE": "1", "TFQ_PAIRS_COLGROUP": "1"}),
        ("pairs", {"TFQ_PAIRS_RTILE": "2"}),
        ("xla", {}),
    ]


def refused(e: Exception) -> bool:
    """Whether ``e`` is a configuration's refusal, which the race records
    as an error row: a ``ValueError`` (a pattern that cannot be packed or
    grouped, a tile the kernel cannot hold) or a ``TfqmrgpuError`` other
    than a failed launch (a precision, block size or engine that the
    configuration does not take).  Anything else (a kernel that does not
    build, a launch that fails, a CUDA error) is a fault, and propagates:
    a plain engine never wins in place of a kernel that broke."""
    if isinstance(e, TfqmrgpuError):
        return e.code != Status.LAUNCH_FAILED
    return isinstance(e, ValueError)


@contextlib.contextmanager
def environment(env: dict):
    """``os.environ`` with ``env`` set (a value of None unsets the key)
    inside the block, and as it was after it."""
    saved = {k: os.environ.pop(k, None) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _search_neighbours(env: dict, solver: Solver) -> list:
    """One-knob moves from a packed 'pairs' winner: the column group size
    halved and doubled (1 <= G <= 16, G*LN <= 512, as in the JAX package),
    and TFQ_PAIRS_RTILE 1 <-> 2 (in place of the JAX package's t_step,
    VMEM-cap and copy_g moves, which the card has no use for)."""
    out = []
    g_cur = solver._gp.group_size if solver._gp is not None else 1
    for g in (g_cur // 2, g_cur * 2):
        if 1 <= g <= 16 and g * solver.ln <= GROUP_LANE_LIMIT and g != g_cur:
            out.append({**env, "TFQ_PAIRS_COLGROUP": str(g)})
    r_next = {1: 2, 2: 1}.get(solver._pp_plan.r_tile)
    if r_next is not None:
        out.append({**env, "TFQ_PAIRS_RTILE": str(r_next)})
    return out


def autotune_solver(a: Bsr, x: Bsr, b: Bsr, *, precision: str = "c",
                    tolerance: float = 1e-5, max_iterations: int = 200,
                    candidates: Optional[list] = None, nrep: int = 16,
                    use_cache: bool = True, search_budget: int = 8,
                    echo: int = 0, device=None):
    """Measure candidate engine configurations on the isolated multiply;
    return (best Solver, table).

    Every candidate Solver is built on ``device`` (the card unless given)
    under its environment, which is restored afterwards; one that refuses
    its configuration (``refused``) becomes a table row with ``error``,
    and any other exception ends the race and writes no cache entry.
    When the packed 'pairs' engine wins, a bounded coordinate-descent
    search moves its knobs one at a time (``_search_neighbours``;
    ``search_budget`` more measurements, TFQ_AUTOTUNE_SEARCH overrides
    it, 0 disables the search); an accepted move re-opens its neighbours.  The winner persists in the cache keyed
    by the pattern (see the module docstring); a cache hit builds the
    winning configuration without measuring and returns it with the table
    ``[dict(**hit, cached=True)]``.  ``tolerance`` and ``max_iterations``
    are the JAX signature's and unused: the timing is of the multiply
    alone."""
    del tolerance, max_iterations
    probe = Solver(a, x, b, precision=precision, engine="xla", echo=0,
                   device=device)
    device = probe.device
    if candidates is None:
        candidates = default_candidates(precision, lm=probe.lm)
    key = _pattern_key(probe.plan, probe.lm, probe.ln, precision)

    def build(engine: str, env: dict) -> Solver:
        with environment(env):
            return Solver(a, x, b, precision=precision, engine=engine,
                          echo=echo, plan=probe.plan, device=device)

    if use_cache:
        hit = _load_cache().get(key)
        if hit is not None:
            s = build(hit["engine"], hit.get("env", {}))
            if echo > 0:
                print(f"# autotune: cache hit {hit['engine']} "
                      f"{hit.get('env', {})} "
                      f"({hit.get('ms_per_multiply', '?')} ms/multiply)")
            return s, [dict(**hit, cached=True)]

    def measure(engine: str, env: dict, **extra):
        """(Solver, seconds, row), or (None, inf, error row)."""
        try:
            s = build(engine, env)
            dt = time_multiply(s, nrep=nrep)
        except (TfqmrgpuError, ValueError) as e:
            if not refused(e):
                raise
            row = dict(engine=engine, env=dict(env),
                       error=f"{type(e).__name__}: {e}", **extra)
            if echo > 0:
                print(f"# autotune: {engine} {env} unavailable ({e})")
            return None, float("inf"), row
        row = dict(engine=engine, env=dict(env),
                   ms_per_multiply=round(dt * 1e3, 4), **extra)
        if echo > 0:
            print(f"# autotune: {engine} {env} -> {dt * 1e3:.3f} ms/multiply")
        return s, dt, row

    table = []
    best = None
    for engine, env in candidates:
        s, dt, row = measure(engine, env)
        table.append(row)
        if s is not None and (best is None or dt < best[1]):
            best = (s, dt, row)
    if best is None:
        raise RuntimeError("no engine configuration succeeded")

    budget = int(os.environ.get("TFQ_AUTOTUNE_SEARCH", str(search_budget)))
    if budget > 0 and best[0]._packed:
        cur_env = dict(best[2]["env"])
        seen = {json.dumps(cur_env, sort_keys=True)}
        improved = True
        while improved and budget > 0:
            improved = False
            for env in _search_neighbours(cur_env, best[0]):
                k = json.dumps(env, sort_keys=True)
                if k in seen or budget <= 0:
                    continue
                seen.add(k)
                budget -= 1
                s, dt, row = measure("pairs", env, search=True)
                table.append(row)
                if s is not None and dt < best[1]:
                    best = (s, dt, row)
                    cur_env = dict(env)
                    improved = True
                    break                       # re-open the neighbourhood

    if use_cache:
        _store_cache(key, {k: best[2][k]
                           for k in ("engine", "env", "ms_per_multiply")})
    return best[0], table

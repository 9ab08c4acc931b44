"""The port's autotuner (``tfqmrgpu_tpu_torch.autotune``) and the engine
knobs it races, against the JAX package's on the CPU.

* ``_pattern_key`` hashes the JAX package's bytes: equal to its key for
  the same pattern on the CPU, different for another pattern or card.
* ``default_candidates`` is the JAX list less the knobs the card's engines
  do not have (VMEM and scalar-core knobs); in 'z' the JAX list's 'pairs'
  rows run its packed route on the oz kernel (TFQ_PAIRS_Z_OZ=1, with the
  TFQ_OZC_INT8 layouts) and K1 joins them; at LM <= 8 its
  TFQ_SOLVER_SUPER entries are the JAX list's ('z': with the knob), and
  the race has rows for them ('z': refused where the oz kernel's LM stays
  below 16).
* ``ops/rates.py`` holds the card's 'c' and 'z' rows and no data-sheet
  peak.
* TFQ_PALLAS_RTILE, TFQ_PAIRS_COLGROUP and TFQ_PAIRS_RTILE give the JAX
  Solver's packs (JAX packs on the host; its resident plan, no superblock);
  unset, the packs are the ones the engines built before the knobs.
* ``time_multiply`` over every engine; ``autotune_solver``: a row per
  candidate with errors recorded, a winner that solves to the dense
  reference and equals a Solver built directly under its environment to
  the bit, the cache in TFQ_AUTOTUNE_CACHE, a cache hit that measures
  nothing, the local search within its budget, the environment restored;
  a kernel that fails to build or launch ends the race and caches nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

from conftest import dense_from_bsr, make_random_problem
from test_torch_panel import _plans, _port
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import autotune as jautotune
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu_torch import autotune as tautotune
from tfqmrgpu_tpu_torch import errors as terrors
from tfqmrgpu_tpu_torch import solver as tsolver
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp
from tfqmrgpu_tpu_torch.ops import pallas_spmm as trt

torch.set_num_threads(2)

KNOBS = ("TFQ_PALLAS_RTILE", "TFQ_PAIRS_COLGROUP", "TFQ_PAIRS_RTILE",
         "TFQ_AUTOTUNE_SEARCH", "TFQ_AUTOTUNE_CACHE")
# the JAX candidates' knobs that the card's engines do not have
DROPPED = {"TFQ_PAIRS_TSTEP", "TFQ_PAIRS_COPYG",
           "TFQ_PAIRS_RESIDENT", "TFQ_PAIRS_VMEM_CAP", "TFQ_PAIRS_VMEM"}
Z_OZ = {"TFQ_PAIRS_Z_OZ": "1"}
CDTYPE = {"z": np.complex128, "c": np.complex64}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TFQ_AUTOTUNE_CACHE", str(tmp_path))
    # the JAX Solver packs its fine resident plan, as the port does
    monkeypatch.setenv("TFQ_SOLVER_SUPER", "0")
    monkeypatch.setenv("TFQ_PAIRS_RESIDENT", "1")


def _problem(precision="c", seed=0, mb=12, lm=4, ln=4, ncols=4):
    rng = np.random.default_rng(seed)
    return make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                               x_fill=1.0, dtype=CDTYPE[precision])


# -------------------------------------------------------------- the key

def test_pattern_key_is_the_jax_key_on_the_cpu(monkeypatch):
    a, x, b = _problem()
    jp, tp = _plans(a, x, b, 4, 4)
    native = tt.create_plan(*_port(a, x, b), device="cpu")
    for prec in ("c", "z"):
        want = jautotune._pattern_key(jp, 4, 4, prec)
        assert tautotune._pattern_key(tp, 4, 4, prec) == want
        assert tautotune._pattern_key(native, 4, 4, prec) == want
    other = tt.create_plan(*_port(*_problem(seed=1)), device="cpu")
    key = tautotune._pattern_key(tp, 4, 4, "c")
    assert tautotune._pattern_key(other, 4, 4, "c") != key
    assert tautotune._pattern_key(tp, 4, 8, "c") != key
    monkeypatch.setattr(tautotune, "device_kind",
                        lambda device: "NVIDIA H100 80GB HBM3")
    assert tautotune._pattern_key(tp, 4, 4, "c") != key


@pytest.mark.parametrize("lm", [4, 8, 32])
@pytest.mark.parametrize("precision", ["z", "c"])
def test_default_candidates_are_the_jax_list_filtered(precision, lm):
    want = [(e, env) for e, env in jautotune.default_candidates(precision, lm)
            if not DROPPED & set(env)]
    if precision == "z":
        # the JAX 'pairs' rows are its packed Ozaki route, the port's
        # opt-in; K1, the port's native 'z', joins after 'dense'
        want = [(e, {**env, **Z_OZ} if e == "pairs" else env)
                for e, env in want]
        want.insert(1, ("pairs", {}))
    assert tautotune.default_candidates(precision, lm) == want


@pytest.mark.parametrize("lm", [4, 8])
def test_superblock_candidates_are_the_jax_lists(lm):
    def sup(cands):
        return [(e, env) for e, env in cands if "TFQ_SOLVER_SUPER" in env]

    want = sup(jautotune.default_candidates("c", lm))
    got = tautotune.default_candidates("c", lm)
    assert want and sup(got) == want == got[:len(want)]
    assert [env["TFQ_SOLVER_SUPER"] for _, env in want] == (
        ["0"] + [str(f) for f in sorted({16 // lm, 32 // lm})])
    want_z = [(e, {**env, **Z_OZ})
              for e, env in sup(jautotune.default_candidates("z", lm))]
    assert want_z and sup(tautotune.default_candidates("z", lm)) == want_z
    assert not sup(tautotune.default_candidates("c", 16))
    assert not sup(tautotune.default_candidates("z", 16))


def test_rates_hold_no_z_rows_and_no_peaks():
    from tfqmrgpu_tpu_torch import profiling
    from tfqmrgpu_tpu_torch.ops import rates

    # the 'z' rows are the oz kernel's, read only under TFQ_PAIRS_Z_OZ
    assert set(rates.ENGINE_TFLOPS) == set(rates.BASE_TFLOPS) == {"c", "z"}
    assert sorted(rates.ENGINE_TFLOPS["z"]) == [16, 32]
    assert sorted(rates.BASE_TFLOPS["z"]) == [4, 8]
    assert rates.engine_rate("z", 16) > 0 and rates.engine_rate("z", 64) == 0
    assert rates.engine_rate("c", 64) == 0.0          # never measured
    assert rates.base_rate("c", 2) == min(rates.BASE_TFLOPS["c"].values())
    peaks = {v for row in profiling.DEVICE_PEAKS.values()
             for v in row.values()}
    for prec in ("c", "z"):
        for table in (rates.ENGINE_TFLOPS[prec], rates.BASE_TFLOPS[prec]):
            assert table and all(0 < v for v in table.values())
            assert not peaks & set(table.values())
        # a merged size's rate is above the unmerged baseline it must beat
        assert min(rates.ENGINE_TFLOPS[prec].values()) > max(
            rates.BASE_TFLOPS[prec].values())


# ------------------------------------------------------------- the knobs

@pytest.mark.parametrize("r_tile", ["1", "2", "4"])
def test_pallas_rtile_knob_gives_the_jax_pack(monkeypatch, r_tile):
    monkeypatch.setenv("TFQ_PALLAS_RTILE", r_tile)
    a, x, b = _problem(seed=2, mb=16, lm=8, ln=8)
    js = jsolver.Solver(a, x, b, precision="c", engine="pallas")
    ts = tt.Solver(*_port(a, x, b), precision="c", engine="pallas",
                   device="cpu")
    got, want = ts._pack, js._pack
    assert got.r_tile == int(r_tile)
    assert (got.r_tile, got.ku, got.ntiles) == (want.r_tile, want.ku,
                                                want.ntiles)
    assert np.array_equal(got.xcols, want.xcols)


@pytest.mark.parametrize("group,r_tile", [("1", "1"), ("1", "2"), ("2", "1"),
                                          ("2", "2"), ("4", "1")])
def test_pairs_knobs_give_the_jax_pack(monkeypatch, group, r_tile):
    monkeypatch.setenv("TFQ_PAIRS_COLGROUP", group)
    monkeypatch.setenv("TFQ_PAIRS_RTILE", r_tile)
    a, x, b = _problem(seed=3)
    js = jsolver.Solver(a, x, b, precision="c", engine="pairs")
    _, tp = _plans(a, x, b, 4, 4)
    ts = tt.Solver(*_port(a, x, b), precision="c", engine="pairs", plan=tp,
                   device="cpu")
    got, want = ts._pp_plan, js._pp_plan
    assert (ts._gp.group_size if ts._gp else 1) == int(group) == (
        js._gp.group_size if js._gp else 1)
    assert got.r_tile == int(r_tile)
    assert (got.r_tile, got.ntiles, got.ku, got.ln) == (
        want.r_tile, want.ntiles, want.ku, want.ln)
    assert np.array_equal(got.xloc, want.xloc)


def test_knobs_unset_give_the_packs_of_before(monkeypatch):
    a, x, b = _problem(seed=4, mb=16, lm=8, ln=8)
    port = _port(a, x, b)
    rows = tt.Solver(*port, precision="c", engine="pallas", device="cpu")
    packed = tt.Solver(*port, precision="c", engine="pairs", device="cpu")
    want = trt.choose_row_tile(rows.plan, 8)
    assert (rows._pack.r_tile, rows._pack.ku) == (want.r_tile, want.ku)
    gp, pp = tsolver.pack_pairs(packed.plan, 8, 8, group_size=0, r_tile=1)
    assert packed._pp_plan.r_tile == 1
    assert (packed._gp.group_size if packed._gp else 1) == (
        gp.group_size if gp else 1)
    assert np.array_equal(packed._pp_plan.xloc, pp.xloc)
    # explicit arguments win over the environment (the sharded layout's)
    monkeypatch.setenv("TFQ_PAIRS_RTILE", "2")
    monkeypatch.setenv("TFQ_PAIRS_COLGROUP", "1")
    _, pp1 = tsolver.pack_pairs(packed.plan, 8, 8, group_size=0, r_tile=1)
    assert pp1.r_tile == 1 and np.array_equal(pp1.xloc, pp.xloc)
    # the Solver reads TFQ_PALLAS_RTILE; the ops function reads no knob
    monkeypatch.setenv("TFQ_PALLAS_RTILE", "2" if want.r_tile == 1 else "1")
    assert trt.choose_row_tile(rows.plan, 8).r_tile == want.r_tile


# ------------------------------------------------------- time_multiply

@pytest.mark.parametrize("engine,precision", [
    ("dense", "z"), ("pairs", "z"), ("xla", "z"), ("dense", "c"),
    ("pallas", "c"), ("pairs", "c"), ("xla", "c")])
def test_time_multiply_is_positive(engine, precision):
    s = tt.Solver(*_port(*_problem(precision, seed=5)), precision=precision,
                  engine=engine, device="cpu")
    assert s.engine == engine
    assert tautotune.time_multiply(s, nrep=3) > 0.0


def test_multiply_chain_keeps_the_packed_zeros(monkeypatch):
    """The grouped packed engine's absent lanes stay zero through the
    chain, as in the solve."""
    monkeypatch.setenv("TFQ_PAIRS_COLGROUP", "4")
    rng = np.random.default_rng(6)
    a, x, b = make_random_problem(rng, mb=12, lm=4, ln=4, ncols=6,
                                  x_fill=1.0, dtype=np.complex64)
    s = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                  device="cpu")
    assert s._gp.group_size == 4          # 6 columns: one group half full
    lanes = torch.from_numpy(tpp.grouped_lane_mask(s._pp_plan, s._gp))
    chain, x0 = tautotune.multiply_chain(s, 3)
    y = chain(x0 + 1.0).view(-1, 4, 2 * s._pp_plan.ln)
    assert torch.isfinite(y).all() and y.abs().max() == 1.0
    assert not (y * (1 - lanes[:, None, :])).any()


# ------------------------------------------------------------ autotune

def _dense_solution(a, x, b, lm, ln):
    """X by a dense solve (X full, so the pattern changes nothing)."""
    xs = np.linalg.solve(dense_from_bsr(a, lm, lm), dense_from_bsr(b, lm, ln))
    return xs.reshape(x.nrows, lm, x.ncols, ln).transpose(0, 2, 1, 3)


def _cache(tmp_path) -> dict:
    with open(tmp_path / "autotune.json") as f:
        return json.load(f)


@pytest.mark.parametrize("precision,tol", [("c", 1e-5), ("z", 1e-10)])
def test_autotune_races_caches_and_hits(monkeypatch, tmp_path, precision,
                                        tol):
    a, x, b = _problem(precision, seed=7)
    port = _port(a, x, b)
    env_before = dict(os.environ)
    calls = []
    real = tautotune.time_multiply

    def counted(solver, **kw):
        calls.append(solver.engine)
        return real(solver, **kw)

    monkeypatch.setattr(tautotune, "time_multiply", counted)
    s, table = tt.autotune_solver(*port, precision=precision, nrep=2,
                                  device="cpu")
    assert dict(os.environ) == env_before
    cands = tautotune.default_candidates(precision, 4)
    race = [r for r in table if not r.get("search")]
    assert [(r["engine"], r["env"]) for r in race] == cands
    # at LM 4 the superblock candidates race too
    assert [r["env"].get("TFQ_SOLVER_SUPER") for r in race
            if "TFQ_SOLVER_SUPER" in r["env"]] == ["0", "4", "8"]
    # 'z': the oz kernel needs LM >= 16, so the packed candidates are
    # refused but where a merge lifts LM to 16 or 32
    refused = [r for r in race if "error" in r]
    assert [r["env"] for r in refused] == (
        [] if precision == "c" else
        [e for en, e in cands if "TFQ_PAIRS_Z_OZ" in e
         and e.get("TFQ_SOLVER_SUPER") in (None, "0")])
    assert all(r["ms_per_multiply"] >= 0 for r in table if "error" not in r)
    assert len(calls) == len(table) - len(refused)
    # the winner: the cache's one entry, which solves to the dense
    # reference and equals a Solver built directly under its environment
    (entry,) = _cache(tmp_path).values()
    assert set(entry) == {"engine", "env", "ms_per_multiply"}
    assert s.engine == entry["engine"]
    info = s.solve(tolerance=tol, max_iterations=300)
    assert info.return_status == 0
    got = s.get_matrix("X")
    want = _dense_solution(a, x, b, 4, 4)
    blocks = want[x.row_of(), x.colind]
    assert np.max(np.abs(got - blocks)) <= 1e3 * tol * np.max(np.abs(blocks))
    with tautotune.environment(entry["env"]):
        direct = tt.Solver(*port, precision=precision,
                           engine=entry["engine"], device="cpu")
    dinfo = direct.solve(tolerance=tol, max_iterations=300)
    assert dinfo.iterations_needed == info.iterations_needed
    assert np.array_equal(direct.get_matrix("X"), got)
    # a second call: a cache hit that measures nothing
    calls.clear()
    s2, again = tt.autotune_solver(*port, precision=precision, nrep=2,
                                   device="cpu")
    assert calls == [] and again == [dict(**entry, cached=True)]
    assert s2.engine == entry["engine"]
    assert dict(os.environ) == env_before


def test_autotune_records_errors_and_raises_when_none_runs(tmp_path):
    port = _port(*_problem("z", seed=8))
    s, table = tt.autotune_solver(*port, precision="z", nrep=2,
                                  candidates=[("pallas", {}), ("xla", {})],
                                  device="cpu")
    assert s.engine == "xla"
    assert table[0]["engine"] == "pallas"
    assert "float32-only" in table[0]["error"]
    assert "ms_per_multiply" in table[1]
    with pytest.raises(RuntimeError, match="no engine configuration"):
        tt.autotune_solver(*port, precision="z", nrep=2, use_cache=False,
                           candidates=[("pallas", {})], device="cpu")


FAULTS = {
    "build": lambda: RuntimeError("nvcc failed"),
    "launch": lambda: terrors.TfqmrgpuError(
        terrors.encode_status(terrors.Status.LAUNCH_FAILED),
        "kernel returned 1"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("wrapper,engine,precision", [
    (tpp.PairPlanMultiply, "pairs", "z"),
    (tpp.PairPanelMultiply, "pairs", "c"),
    (trt.RowTileMultiply, "pallas", "c")])
def test_autotune_propagates_a_kernel_fault(monkeypatch, tmp_path, fault,
                                            wrapper, engine, precision):
    """A kernel that does not build or launch ends the race: no plain
    engine is crowned in its place and nothing is cached."""
    def broken(self, *args, **kw):
        raise FAULTS[fault]()

    monkeypatch.setattr(wrapper, "plain", broken)
    port = _port(*_problem(precision, seed=8))
    env_before = dict(os.environ)
    with pytest.raises(RuntimeError) as exc:
        tt.autotune_solver(*port, precision=precision, nrep=2,
                           candidates=[("xla", {}), (engine, {})],
                           device="cpu")
    assert not tautotune.refused(exc.value)
    assert not (tmp_path / "autotune.json").exists()
    assert dict(os.environ) == env_before


@pytest.mark.parametrize("exc,want", [
    (ValueError("a ragged pattern"), True),
    (terrors.TfqmrgpuValueError(
        terrors.encode_status(terrors.Status.PRECISION_MISSMATCH)), True),
    (terrors.TfqmrgpuError(terrors.encode_status(
        terrors.Status.BLOCKSIZE_MISSING)), True),
    (terrors.TfqmrgpuError(terrors.encode_status(
        terrors.Status.LAUNCH_FAILED)), False),
    (RuntimeError("nvcc failed"), False),
    (torch.OutOfMemoryError("CUDA out of memory"), False),
    (KeyError("x"), False)])
def test_refused_tells_a_refusal_from_a_fault(exc, want):
    assert tautotune.refused(exc) is want


@pytest.mark.parametrize("env_budget,want", [(None, 2), ("1", 1), ("0", 0)])
def test_autotune_search_keeps_its_budget(monkeypatch, env_budget, want):
    if env_budget is not None:
        monkeypatch.setenv("TFQ_AUTOTUNE_SEARCH", env_budget)
    env_before = dict(os.environ)
    port = _port(*_problem(seed=9))
    s, table = tt.autotune_solver(
        *port, precision="c", nrep=2, use_cache=False, search_budget=2,
        candidates=[("pairs", {"TFQ_PAIRS_RTILE": "1"})], device="cpu")
    search = [r for r in table if r.get("search")]
    assert len(search) == want and len(table) == 1 + want
    for r in search:
        assert r["engine"] == "pairs" and "ms_per_multiply" in r
        moved = {k for k in r["env"] if r["env"][k] != {
            "TFQ_PAIRS_RTILE": "1"}.get(k)}
        assert moved <= {"TFQ_PAIRS_COLGROUP", "TFQ_PAIRS_RTILE"}
    assert s._packed
    assert dict(os.environ) == env_before


def test_environment_sets_unsets_and_restores(monkeypatch):
    monkeypatch.setenv("TFQ_PAIRS_RTILE", "2")
    monkeypatch.delenv("TFQ_PAIRS_COLGROUP", raising=False)
    before = dict(os.environ)
    with pytest.raises(KeyError):
        with tautotune.environment({"TFQ_PAIRS_RTILE": None,
                                    "TFQ_PAIRS_COLGROUP": "4"}):
            assert "TFQ_PAIRS_RTILE" not in os.environ
            assert os.environ["TFQ_PAIRS_COLGROUP"] == "4"
            raise KeyError("leaves the block")
    assert dict(os.environ) == before

"""The port's sharded packed-pairs engine and its comm model
(``tfqmrgpu_tpu_torch.parallel.sharded_pairs`` and ``comm_model``) against
the JAX package's on the CPU.

* Layouts: for pr 2 and 4 the port's ``ShardedPairsLayout`` (tile chunks,
  the local/remote split, the neighbour-halo decision, the column groups)
  equals the JAX ``ShardedPairsSolver``'s, built with ``interpret=True``
  and never solved, on its resident plan (``TFQ_PAIRS_RESIDENT=1``) at the
  same group size (``TFQ_PAIRS_COLGROUP``); ``pairs_comm_report``'s byte
  counts and local tile fraction equal the JAX model's.
* Solves over gloo ranks (``torch_sharded_worker.run_ranks``, where K2 runs
  its plain version): against JAX's sharded solve in interpret mode at pr 2
  with JAX's v3 (the same status, iterations within 1, X within 1e-4); and,
  with the gates of the JAX package's tests/test_sharded_pairs.py
  (iterations within 1 of the port's single-device 'pairs' solve, a dense
  residual below 50*tol), at pr 2 and 4: the overlap split against every
  tile remote and the neighbour halo against the ``all_gather``, X equal to
  the bit; grouped against ungrouped; at world size 1 X equal to
  ``Solver(engine='pairs')``'s to the bit.
* K2 over tile-id lists: rebased sources checked against their span, and
  the parts of one multiply filling one Y at their row offsets.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tfqmrgpu_tpu_torch as tt
from conftest import dense_from_bsr, make_random_problem
from test_sharded_pairs import _banded_problem
from test_torch_solver import _port
from tfqmrgpu_tpu import create_plan as jax_create_plan
from tfqmrgpu_tpu.core import make_shadow_vector as jax_shadow_vector
from tfqmrgpu_tpu.parallel import comm_model as jax_comm
from tfqmrgpu_tpu.parallel import make_mesh as jax_make_mesh
from tfqmrgpu_tpu.parallel.sharded_pairs import (
    ShardedPairsSolver as JaxShardedPairsSolver)
from tfqmrgpu_tpu_torch.ops import pairpanel as tpp
from tfqmrgpu_tpu_torch.parallel import ShardedPairsLayout, comm_model
from torch_sharded_worker import pack_problems, run_ranks

torch.set_num_threads(2)

LM = LN = 4
TOL = 1e-4
LAYOUT_FIELDS = ("tiles_local", "ntiles_pad", "vrows_local", "p", "q",
                 "n_loc", "overlap", "loc_resident", "halo", "h_lo", "h_hi")
BYTE_FIELDS = ("gather_bytes_per_multiply", "reduction_bytes_per_iteration",
               "collective_bytes_per_iteration", "local_tile_fraction")


def _problems():
    """The JAX tests' problems: random with 3 columns (test_sharded_pairs_
    matches_single_device), random column-sparse with 4 (grouped), the
    clamped band with one column (neighbour halo) and with two (overlap)."""
    rng = np.random.default_rng(42)
    return dict(
        rand3=make_random_problem(rng, mb=12, lm=LM, ln=LN, ncols=3,
                                  x_fill=1.0, dtype=np.complex64),
        sparse4=make_random_problem(rng, mb=12, lm=LM, ln=LN, ncols=4,
                                    x_fill=0.6, dtype=np.complex64),
        band1=_banded_problem(96, 1, LM, LN),
        band2=_banded_problem(96, 2, LM, LN))


PROBLEMS = _problems()

# (problem, pr, group size, overlap, halo)
LAYOUTS = [("rand3", 2, 1, True, True), ("rand3", 2, 2, True, True),
           ("rand3", 4, 2, True, True), ("sparse4", 2, 2, True, True),
           ("band1", 2, 1, True, True), ("band1", 4, 1, True, True),
           ("band1", 2, 1, True, False), ("band2", 4, 2, True, True),
           ("band2", 2, 1, False, True)]
LAYOUT_IDS = [f"{n}-pr{pr}-G{g}" + ("" if ov else "-no_overlap")
              + ("" if h else "-no_halo") for n, pr, g, ov, h in LAYOUTS]


def _jax_layout(monkeypatch, name, pr, group, overlap, halo):
    """The JAX solver, built and never solved, on its resident plan."""
    a, x, b = PROBLEMS[name]
    monkeypatch.setenv("TFQ_PAIRS_RESIDENT", "1")
    monkeypatch.setenv("TFQ_PAIRS_COLGROUP", str(group))
    if not halo:
        monkeypatch.setenv("TFQ_SHARDED_HALO", "0")
    plan = jax_create_plan(a, x, b)
    plan.lm, plan.ln = LM, LN
    return JaxShardedPairsSolver(plan, jax_make_mesh(pr, 1), interpret=True,
                                 overlap=overlap)


def _port_plan(name):
    plan = tt.create_plan(*_port(*PROBLEMS[name]), device="cpu")
    plan.lm, plan.ln = LM, LN
    return plan


def _port_layout(name, pr, group, overlap, halo):
    return ShardedPairsLayout(_port_plan(name), pr, overlap=overlap,
                              halo=halo, group_size=group)


@pytest.mark.parametrize("name,pr,group,overlap,halo", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_layout_matches_jax(monkeypatch, name, pr, group, overlap, halo):
    want = _jax_layout(monkeypatch, name, pr, group, overlap, halo)
    got = _port_layout(name, pr, group, overlap, halo)
    for k in LAYOUT_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.group_size == (want.gp.group_size if want.gp else 1)
    assert got.n_oh == want.n_oh and got.ln == want.ln


@pytest.mark.parametrize("name,pr,group,overlap,halo", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_comm_bytes_match_jax(monkeypatch, name, pr, group, overlap, halo):
    want = jax_comm.pairs_comm_report(
        _jax_layout(monkeypatch, name, pr, group, overlap, halo))
    got = comm_model.pairs_comm_report(
        _port_layout(name, pr, group, overlap, halo))
    assert got["weak_scalable"] == want["weak_scalable"]
    for k in BYTE_FIELDS:
        assert got[k] == want[k], k
    # the card's rates, stated
    a = got["assumptions"]
    assert (a["nvlink_bytes_per_s"], a["hbm_bytes_per_s"],
            a["fp32_flops_per_s"]) == (450e9, 3.35e12, 67e12)
    assert "H100" in a["source"]
    assert 0.0 < got["modeled_efficiency"] <= 1.0


def test_halo_and_overlap_engage():
    """The layouts the solves below rely on: the one-column band engages
    the neighbour halo at pr 2 and 4, and the two-column band at pr 4;
    ``overlap=False`` makes every tile remote and gathered."""
    for pr in (2, 4):
        lay = _port_layout("band1", pr, 1, True, True)
        assert lay.halo and lay.h_lo and lay.h_hi and lay.n_loc > 0
        no = _port_layout("band1", pr, 1, False, True)
        assert (no.p, no.q, no.n_loc, no.halo) == (no.tiles_local, 0, 0,
                                                   False)
    assert _port_layout("band2", 4, 1, True, True).halo


def test_layout_needs_no_process_group():
    """A layout comes from the pattern alone, at any pr, with no process
    group (the comm model builds them for shard counts it does not run)."""
    assert not dist.is_initialized()
    plan = _port_plan("band1")
    for pr in (1, 3, 8, 16):
        lay = ShardedPairsLayout(plan, pr)
        assert lay.pr == pr and len(lay.shards) == pr
        assert lay.ntiles_pad >= lay.pp_plan.ntiles
        assert lay.pairs_local.sum() == plan.n_pairs
    assert not dist.is_initialized()


def test_weak_scaling_model_rows():
    """Every row is a real layout; the halo keeps a shard's gather bytes
    constant as pr grows."""
    rows = comm_model.weak_scaling_model(mb_per_shard=16, lm=8, ln=8,
                                         prs=(1, 2, 4, 8))
    assert [r["pr"] for r in rows] == [1, 2, 4, 8]
    assert all(r["measured_objects"] for r in rows)
    assert rows[0]["gather_bytes_per_multiply"] == 0
    halo = [r["gather_bytes_per_multiply"] for r in rows[1:]]
    assert all(r["weak_scalable"] for r in rows) and len(set(halo)) == 1
    assert "H100" in rows[0]["assumptions"]["source"]


# ------------------------------------------------------ K2 over tile lists

def _tiles_case():
    plan = _port_plan("band1")
    lay = ShardedPairsLayout(plan, 5)          # 96 tiles: 4 pad tiles
    p0 = lay.pp_plan
    rng = np.random.default_rng(3)
    a = [torch.from_numpy(rng.standard_normal((plan.nnzb_a, LM, LM))
                          .astype(np.float32)) for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal(
        (lay.vec_rows_pad, 2 * lay.ln)).astype(np.float32))
    return lay, p0, a, x


def test_tile_list_sources_outside_span_raise():
    lay, p0, a, _ = _tiles_case()
    t = lay.shards[1]
    bl = lay.blocks_local
    tpp.tile_tables(p0, t.local, t.local_base, bl)      # inside: fine
    with pytest.raises(ValueError, match="outside the span"):
        tpp.tile_tables(p0, t.prefix, t.local_base, bl)  # reads shard 0
    with pytest.raises(ValueError, match="outside the span"):
        tpp.tile_tables(p0, t.local, t.local_base + 1, bl)
    with pytest.raises(ValueError, match="outside the span"):
        tpp.PairPanelMultiply(
            p0, tpp.build_a_panels_device(p0, *a, tiles=t.prefix),
            tiles=t.prefix, src_base=t.local_base, span=bl)
    with pytest.raises(ValueError, match="tile ids"):
        tpp.tile_tables(p0, [p0.ntiles], 0, 0)


def test_tile_list_parts_fill_one_y():
    """Every shard's local run (over its own rows, rebased) and remote
    prefix and suffix (over the whole panel) write their rows of one Y
    each: together the full plan's product; pad tiles write zeros."""
    lay, p0, a, x = _tiles_case()
    full = tpp.PairPanelMultiply(p0, tpp.build_a_panels_device(p0, *a))
    want = full(x[:p0.n_slots * LM])
    m, rows = lay.r_tile * LM, lay.vrows_local
    whole = lay.pr * lay.blocks_local
    for s, t in enumerate(lay.shards):
        y = torch.full((rows, 2 * lay.ln), float("nan"))
        xs = x[s * rows:(s + 1) * rows].contiguous()
        for tiles, xx, base, span, row0 in (
                (t.local, xs, t.local_base, lay.blocks_local, lay.p * m),
                (t.prefix, x, 0, whole, 0),
                (t.suffix, x, 0, whole, (lay.tiles_local - lay.q) * m)):
            if tiles.size:
                k2 = tpp.PairPanelMultiply(
                    p0, tpp.build_a_panels_device(p0, *a, tiles=tiles),
                    tiles=tiles, src_base=base, span=span)
                assert k2(xx, y, row0).data_ptr() == y[row0].data_ptr()
        w = torch.zeros_like(y)
        real = want[s * rows:(s + 1) * rows]
        w[:real.shape[0]] = real
        torch.testing.assert_close(y, w, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="outside"):
        k2(xx, y, rows)


# ------------------------------------------------------------ the solves

def _dense_rel(name, got):
    a, x, b = PROBLEMS[name]
    ad = dense_from_bsr(a, LM, LM)
    xd = dense_from_bsr(x.with_data(np.asarray(got)), LM, LN)
    bd = dense_from_bsr(b, LM, LN)
    return np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd))


def _single(name):
    s = tt.Solver(*_port(*PROBLEMS[name]), precision="c", engine="pairs",
                  device="cpu")
    return s.solve(tolerance=TOL, max_iterations=300).iterations_needed


# (problem, overlap, halo, group_size, v3 key)
RUNS = [("rand3", 1, 1, 0, ""), ("band2", 1, 1, 1, ""),
        ("band2", 0, 1, 1, ""), ("band1", 1, 1, 1, ""),
        ("band1", 1, 0, 1, ""), ("sparse4", 1, 1, 2, ""),
        ("sparse4", 1, 1, 1, "")]


def _run(world, tmp_path, runs, **extra):
    rows = [[n, str(ov), str(h), str(g), str(TOL), "300", v3]
            for n, ov, h, g, v3 in runs]
    got = run_ranks("pairs", world, dict(pack_problems(**PROBLEMS),
                                         runs=np.array(rows), **extra),
                    tmp_path)
    return [{k.split("_", 1)[1]: v for k, v in got.items()
             if k.startswith(f"{i}_")} for i in range(len(runs))]


@pytest.fixture(scope="module", params=[2, 4], ids=["pr2", "pr4"])
def sharded_runs(request, tmp_path_factory):
    return request.param, _run(request.param,
                               tmp_path_factory.mktemp("pairs"), RUNS)


def test_sharded_pairs_matches_single_device(sharded_runs):
    pr, runs = sharded_runs
    for (name, *_), r in zip(RUNS, runs):
        assert int(r["return_status"]) == 0, name
        if name == "sparse4":
            continue    # X's pattern is not full: no dense gate (as in JAX)
        assert abs(int(r["iterations"]) - _single(name)) <= 1, name
        assert _dense_rel(name, r["x"]) < 50 * TOL, name
        # one all_reduce a dotp or nrm2 and one of a decision's partials:
        # 5 an iteration, 2 a probe, 1 for |B|
        its, probes = int(r["iterations"]), int(r["n_probes"])
        assert int(r["all_reduce"]) == 5 * its + 2 * probes + 1


def test_sharded_pairs_overlap_bits(sharded_runs):
    """The local/remote split changes no bit: the two-column band with the
    split against every tile remote through the gathered panel."""
    pr, runs = sharded_runs
    split, remote = runs[1], runs[2]
    assert int(split["n_loc"]) > 0 and int(remote["n_loc"]) == 0
    assert int(remote["p"]) == int(remote["tiles_local"])
    assert int(split["iterations"]) == int(remote["iterations"])
    np.testing.assert_array_equal(split["x"], remote["x"])
    # every multiply of the remote run gathers; the X gather adds one
    its, probes = int(remote["iterations"]), int(remote["n_probes"])
    assert int(remote["all_gather"]) == 2 * its + probes + 1


def test_sharded_pairs_neighbour_halo_bits(sharded_runs):
    """The neighbour halo (edge slabs over batch_isend_irecv) against the
    all_gather of the whole panel: the same iterations, X to the bit."""
    pr, runs = sharded_runs
    halo, gather = runs[3], runs[4]
    assert bool(halo["halo"]) and not bool(gather["halo"])
    assert int(halo["h_lo"]) and int(halo["h_hi"])
    its, probes = int(halo["iterations"]), int(halo["n_probes"])
    assert int(halo["neighbour_exchange"]) == 2 * its + probes
    assert int(halo["all_gather"]) == 1 and int(gather["all_gather"]) > 1
    assert int(halo["iterations"]) == int(gather["iterations"])
    np.testing.assert_array_equal(halo["x"], gather["x"])


def test_sharded_pairs_grouped_matches_ungrouped(sharded_runs):
    """Forced G = 2 against ungrouped (the JAX test's gates: iterations
    within 2, X within 1e-4 of the largest entry)."""
    pr, runs = sharded_runs
    grouped, plain = runs[5], runs[6]
    assert int(grouped["group_size"]) == 2 and int(plain["group_size"]) == 1
    assert abs(int(grouped["iterations"]) - int(plain["iterations"])) <= 2
    scale = np.abs(plain["x"]).max()
    assert np.abs(grouped["x"] - plain["x"]).max() / scale < 1e-4


def test_sharded_pairs_world_size_one_bits(tmp_path):
    """At world size 1 every tile is local, the rebase is 0 and the
    all_reduce of one rank changes nothing: X equals the single-device
    packed solve's to the bit, with and without the split."""
    runs = _run(1, tmp_path, [("rand3", 1, 1, 0, ""), ("band1", 1, 1, 1, ""),
                              ("band1", 0, 1, 1, "")])
    for r in runs:
        assert int(r["iterations"]) == int(r["iterations1"])
        np.testing.assert_array_equal(r["x"], r["x1"])
    assert int(runs[1]["n_loc"]) == int(runs[1]["tiles_local"])
    assert int(runs[2]["n_loc"]) == 0


def test_sharded_pairs_matches_jax_solve(monkeypatch, tmp_path):
    """One solve against JAX's sharded pairs solve in interpret mode at
    pr 2, with JAX's v3 handed over: the same status, iterations within 1,
    X within 1e-4 relative."""
    a, x, b = PROBLEMS["band1"]
    js = _jax_layout(monkeypatch, "band1", 2, 1, True, True)
    v3 = [np.asarray(v) for v in jax_shadow_vector(js.plan.nnzb_x, LM, LN)]
    want, winfo = js.solve(a.data.real, a.data.imag, b.data.real,
                           b.data.imag, tolerance=TOL, max_iterations=300)
    got = _run(2, tmp_path, [("band1", 1, 1, 1, "v3")], v3_re=v3[0],
               v3_im=v3[1])[0]
    assert bool(got["halo"]) == bool(js.halo)
    assert int(got["return_status"]) == int(winfo["return_status"])
    assert abs(int(got["iterations"]) - int(winfo["iterations"])) <= 1
    assert (np.abs(got["x"] - want).max() / np.abs(want).max()) < 1e-4


def test_dryrun_four_ranks(tmp_path):
    """``dryrun_multichip`` at 4 gloo ranks: every sharded engine solves
    within the JAX gates; the packed engine's band takes the halo, its
    wide band the all_gather."""
    got = run_ranks("dryrun", 4, {}, tmp_path)
    for tag in ("block-list", "panel", "pairs", "pairs all_gather",
                "rowtile"):
        assert float(got[f"{tag}.maxdiff"]) < 1e-3, tag
        assert int(got[f"{tag}.status"]) == 0, tag
    assert bool(got["pairs.halo"]) and int(got["pairs.n_loc"]) > 0
    assert not bool(got["pairs all_gather.halo"])

"""The sharded loop as the loop graph holds it (``graphloop.record`` with a
sharded solve's primitives), its cross-rank decision stages and the NaN
rule of the mesh's max, the agreement on a capture and the shutdown of a
process group's loop graphs, on the CPU.

On the card every rank's sharded solve is one CUDA graph whose WHILE body
holds the collectives and the decision's two stages around one all_reduce
(``core.decide_local`` / ``decide_finish``, ``settle_local`` /
``settle_finish``).  Here the ranks are spawned processes over gloo
(``torch_sharded_worker.run_ranks``): the recorded loop, under a capture
that captures nothing and the control's plain versions, must equal the
plain driver to the bit, with the same collectives; the sharded solves
must take JAX's iterations with JAX's v3; the stages must equal a numpy
transcription of JAX's ``decide`` / ``do_probe`` with ``pmax`` / ``pmin``
over ranks; and the mesh's max (``Mesh.reduce_max`` of
``core.decision_partials``) must give JAX's ``pmax`` whatever rank holds a
NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from conftest import make_random_problem
from test_torch_device_loop import (EPS, _bits_equal, _carry, np_decide,
                                    np_probe, values)
from test_torch_sharded import _inputs, _jax_sharded
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu.parallel import make_mesh as jmake_mesh
from tfqmrgpu_tpu.parallel.sharded_rowtile import \
    ShardedRowTileSolver as JShardedRowTileSolver
from tfqmrgpu_tpu.plan import create_plan as jcreate_plan
from tfqmrgpu_tpu_torch import core
from torch_sharded_worker import pack_problem, run_ranks

try:
    from jax import shard_map
except ImportError:                         # older JAX
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)

NAN = float("nan")
# rank r's value is column r: a NaN on rank 0, on rank 1, on both, none
NAN_VALUES = [[NAN, 1.0], [1.0, NAN], [NAN, NAN], [2.0, 3.0],
              [-np.inf, NAN], [NAN, -np.inf], [0.5, 0.5]]
FLAGS = [[1, 0], [0, 1], [1, 1], [0, 0]]


def _jax_pmax_pmin(rows, x64: bool = True):
    """JAX's pmax (float64 rows) or pmin (int32 rows) under shard_map over
    2 forced host devices: each row's answer on both devices."""
    mesh = JMesh(np.array(jax.devices()[:2]), ("r",))
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        def f(v):
            return (jax.lax.pmax(v, "r") if x64
                    else jax.lax.pmin(v, "r"))
        g = jax.jit(shard_map(f, mesh=mesh, in_specs=P("r"),
                              out_specs=P("r")))
        dt = jnp.float64 if x64 else jnp.int32
        return np.stack([np.asarray(g(jnp.asarray(r, dt))) for r in rows])
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_allmax_drops_a_nan_on_any_rank_as_jax_pmax(tmp_path):
    """The mesh's max as the decisions take it (``Mesh.reduce_max`` of
    ``core.decision_partials``) at 2 gloo ranks: a NaN on rank 0 or on
    rank 1 is dropped against the other's number, NaN on both gives -inf,
    the same answer on every rank, equal to JAX's pmax on 2 devices; the
    flags' partials give JAX's pmin of the flags."""
    got = run_ranks("nanmax", 2, dict(world=2, values=np.array(NAN_VALUES),
                                      flags=np.array(FLAGS)), tmp_path)
    want = _jax_pmax_pmin(NAN_VALUES).T           # [rank, scenario]
    assert not np.isnan(want).any()
    assert got["max"].tobytes() == want.tobytes()
    assert np.array_equal(got["all"], _jax_pmax_pmin(FLAGS, x64=False).T)
    assert got["max"][0, 2] == -np.inf            # NaN on every rank


def test_agreements_follow_each_mesh(tmp_path):
    """A capture's agreement (``Mesh.agree``) on a mesh of rank 0 alone and
    then on a mesh of both ranks: no rank waits on a key that no rank sets,
    and no stale key of the first mesh passes on the second, so a capture
    that failed on rank 1 fails on both."""
    got = run_ranks("agree", 2, {}, tmp_path, timeout=60.0)
    assert np.array_equal(got["agreed"], [[1, 1, 1, 0, 1], [1, 1, 1, 0, 1]])


@pytest.mark.parametrize("value", [None, "1", "0"])
def test_the_loop_graph_requires_graph_mixing_off(monkeypatch, value):
    """``multihost.require_graph_mixing_off``, which ``make_mesh`` asks on
    the card, raises naming ``NCCL_GRAPH_MIXING_SUPPORT=0`` unless the
    variable is '0'."""
    from tfqmrgpu_tpu_torch.errors import TfqmrgpuError
    from tfqmrgpu_tpu_torch.parallel import multihost

    if value is None:
        monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    else:
        monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", value)
    if value == "0":
        multihost.require_graph_mixing_off()
    else:
        with pytest.raises(TfqmrgpuError,
                           match="NCCL_GRAPH_MIXING_SUPPORT=0"):
            multihost.require_graph_mixing_off()


def test_shutdown_closes_the_sharded_graphs_first(tmp_path):
    """``multihost.shutdown`` closes every live loop graph of a sharded
    solve, then destroys the process group, on each of 2 gloo ranks."""
    got = run_ranks("shutdown", 2, {}, tmp_path, timeout=60.0)
    assert list(got["closed"]) == [1, 1, 1]
    assert int(got["left"]) == 0 and not bool(got["initialized"])


def _problem(rng):
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=24, lm=lm, ln=ln, ncols=6,
                                  x_fill=0.6)
    return a, x, b, lm, ln


@pytest.mark.parametrize("engine,grid", [("blocklist", (2, 1)),
                                         ("blocklist", (2, 2)),
                                         ("rowtile", (4, 1)),
                                         ("pairs", (2, 1))])
def test_recorded_sharded_loop_is_the_plain_driver(rng, tmp_path, engine,
                                                   grid):
    """Each loop of a sharded solve, recorded as the graph holds it (under a
    dry capture and the plain control, maxit 1), equals the plain driver
    at maxit 1 to the bit, with the same collectives, on every rank; the
    solve runs on and converges.  One iteration and its probe: 2 halo
    all_gathers and 5 all_reduces an iteration (4 column sums and the
    decision's partials), 1 all_gather and 2 all_reduces a probe (the
    packed pairs gather only what their remote tiles read)."""
    a, x, b, lm, ln = _problem(rng)
    if engine != "blocklist":
        lm = ln = 4
        a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=3,
                                      x_fill=1.0, dtype=np.complex64)
    v3 = jcore.make_shadow_vector(jcreate_plan(a, x, b).nnzb_x, lm, ln)
    got = run_ranks("sharded_record", grid[0] * grid[1], _inputs(
        a, x, b, lm, ln, tuple(np.asarray(v) for v in v3), grid=list(grid),
        tol=1e-4 if engine != "blocklist" else 1e-8, maxit=300,
        engine=engine), tmp_path)
    assert int(got["return_status"]) == 0 and int(got["loops"]) == 1
    ag, ar, _ = (int(v) for v in got["first_calls"])
    assert ar == 5 + 2 and (engine == "pairs" or ag == 2 + 1)


@pytest.mark.parametrize("pr,pc", [(2, 1), (2, 2)])
def test_sharded_blocklist_iterations_match_jax(rng, tmp_path, pr, pc):
    """The port's sharded block-list solve (its decisions in the two
    stages) takes JAX's ``sharded_solve`` iterations, probes' outcome and
    status on the same inputs with JAX's v3."""
    a, x, b, lm, ln = _problem(rng)
    tol, maxit = 1e-8, 500
    want, jinfo, v3 = _jax_sharded(a, x, b, lm, ln, pr, pc, tol, maxit)
    got = run_ranks("blocklist", pr * pc, _inputs(
        a, x, b, lm, ln, v3, grid=[pr, pc], tol=tol, maxit=maxit,
        rhs_trivial=False), tmp_path)
    assert int(got["return_status"]) == jinfo["return_status"] == 0
    assert int(got["iterations"]) == jinfo["iterations"]
    np.testing.assert_allclose(got["x"], want, atol=1e-10)


def test_sharded_rowtile_iterations_match_jax(rng, tmp_path):
    """The port's sharded row tiles at 2 x 1 take the iterations of JAX's
    ``ShardedRowTileSolver`` (K3 in interpret mode) with JAX's v3."""
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0, dtype=np.complex64)
    tol, maxit = 1e-4, 300
    plan = jcreate_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    js = JShardedRowTileSolver(plan, jmake_mesh(2, 1), r_tile=2,
                               interpret=True)
    jx, jinfo = js.solve(a.data.real, a.data.imag, b.data.real, b.data.imag,
                         tolerance=tol, max_iterations=maxit)
    v3 = jcore.make_shadow_vector(plan.nnzb_x, lm, ln)
    got = run_ranks("rowtile_v3", 2, dict(
        pack_problem(a, x, b), lm=lm, ln=ln, pr=2, r_tile=2, tol=tol,
        maxit=maxit, v3_re=np.asarray(v3[0]), v3_im=np.asarray(v3[1])),
        tmp_path)
    assert int(got["return_status"]) == int(jinfo["return_status"]) == 0
    assert int(got["iterations"]) == int(jinfo["iterations"])
    np.testing.assert_allclose(got["x"], np.asarray(jx), atol=1e-4)


def test_sharded_solvers_release_their_graphs(rng, tmp_path):
    """A sharded solver is freed with its last reference, the collector
    off, even while its loop graphs hold its loop's primitives: the
    primitives hold the kernels and buffers, not the solver.  (A graph
    that captured NCCL's work must be gone before its communicator is
    destroyed, or ``destroy_process_group`` waits for it.)"""
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    got = run_ranks("release", 1, dict(pack_problem(a, x, b), lm=lm, ln=ln),
                    tmp_path)
    assert int(got["rowtile"]) == 1 and int(got["pairs"]) == 1


# ------------- the stages against numpy transcriptions of JAX's decisions

def np_pmax(vals):
    """JAX's pmax over ranks on the CPU: the identity on one; over more, a
    NaN is dropped and NaN on every rank gives -inf."""
    if len(vals) == 1:
        return vals[0]
    kept = [v for v in vals if not np.isnan(v)]
    return max(kept) if kept else -np.inf


def _ranks(flat, nranks):
    n = max(1, len(flat) // nranks)
    flat = (list(flat) * nranks)[:n * nranks]
    return [np.asarray(flat[r * n:(r + 1) * n], np.float64).reshape(1, n)
            for r in range(nranks)]


def _reduced(parts):
    """The all_reduce MAX of the ranks' partials."""
    return torch.stack(parts).max(dim=0).values


@settings(max_examples=150, deadline=None)
@given(tau=st.lists(values, min_size=1, max_size=16),
       inv=st.sampled_from([0.0, 1.0, 0.5, 1e-300]),
       status=st.lists(st.sampled_from([0, 1, -1, -2, -3]), min_size=16,
                       max_size=16),
       nranks=st.sampled_from([1, 2, 3, 4]), it=st.integers(1, 9),
       maxit=st.integers(1, 9), target=values)
def test_decide_stages_match_numpy_pmax(tau, inv, status, nranks, it, maxit,
                                        target):
    """``decide_finish`` over the MAX of every rank's ``decide_local``
    equals JAX's decide (core.py:188-193) with pmax / pmin over the ranks
    in numpy: NaN columns, zero columns of B and broken columns included."""
    with np.errstate(all="ignore"):
        taus = _ranks(tau, nranks)
        stats = [np.asarray((status * 2)[r * taus[0].size:
                                         (r + 1) * taus[0].size],
                            np.int32).reshape(taus[0].shape)
                 for r in range(nranks)]
        invs = [np.full(t.shape, inv) for t in taus]
        max_ub = np_pmax([np.max(t * i) for t, i in zip(taus, invs)])
        bound = max_ub * float(2 * it + 1)
        all_broke = all(np.all((s == -1) | (s == -2)) for s in stats)
        probe = ((bound <= target) or it >= maxit) and not all_broke
        parts = [core.decide_local(_carry(t, s, it, target),
                                   torch.from_numpy(i), nranks == 1)
                 for t, s, i in zip(taus, stats, invs)]
        got = core.decide_finish(_carry(taus[0], stats[0], it, target),
                                 _reduced(parts),
                                 torch.tensor(maxit, dtype=torch.int32))
        assert int(got[0]) == (2 if all_broke else 0)
        assert _bits_equal(got[1], bound)
        assert bool(got[2]) == probe
        if nranks == 1:      # one rank: the single-device decide's bits
            want = np_decide(taus[0], invs[0], stats[0], it, maxit, target,
                             0)
            assert _bits_equal(got[1], want[1]) and bool(got[2]) == want[2]


@settings(max_examples=150, deadline=None)
@given(res2=st.lists(values, min_size=1, max_size=16),
       status=st.lists(st.sampled_from([0, 1, -1, -2, -3]), min_size=16,
                       max_size=16),
       nranks=st.sampled_from([1, 2, 3, 4]),
       tol2=st.sampled_from([0.0, 1e-20, 1e-10, 1.0, EPS]),
       max_bound2=values, it=st.integers(1, 50))
def test_settle_stages_match_numpy_pmax(res2, status, nranks, tol2,
                                        max_bound2, it):
    """``settle_finish`` over the MAX of every rank's ``settle_local``
    equals JAX's ``do_probe`` (core.py:195-211) with pmax / pmin over the
    ranks in numpy, each rank's status update its own."""
    with np.errstate(all="ignore"):
        rs = _ranks(res2, nranks)
        stats = [np.asarray((status * 2)[r * rs[0].size:
                                         (r + 1) * rs[0].size],
                            np.int32).reshape(rs[0].shape)
                 for r in range(nranks)]
        max_res2 = np.maximum(np_pmax([np.max(r) for r in rs]), EPS)
        is_done = all(np.all((r <= tol2) | (s != 0))
                      for r, s in zip(rs, stats))
        tb2 = (max_bound2 / max_res2) * tol2
        tol2_t = torch.tensor(tol2, dtype=torch.float64)
        mb_t = torch.tensor(max_bound2, dtype=torch.float64)
        locals_ = [core.settle_local(_carry(np.ones(r.shape), s, it, 0.0),
                                     torch.from_numpy(r), tol2_t, nranks == 1)
                   for r, s in zip(rs, stats)]
        for (status_r, _), r, s in zip(locals_, rs, stats):
            assert np.array_equal(status_r.numpy(), np.where(r <= 0, 1, s))
        c = _carry(np.ones(rs[0].shape), stats[0], it, 0.0)
        got = core.settle_finish(c, locals_[0][0],
                                 _reduced([p for _, p in locals_]), mb_t,
                                 tol2_t)
        assert _bits_equal(got.residual2, max_res2)
        assert _bits_equal(got.target_bound2, tb2)
        assert (int(got.stop_code), int(got.iters_needed),
                int(got.n_probes)) == ((1, it, 4) if is_done else (0, 50, 4))
        if nranks == 1:
            want = np_probe(rs[0], stats[0], tol2, max_bound2, 0, 50, 3, it)
            assert _bits_equal(got.residual2, want[2])
            assert _bits_equal(got.target_bound2, want[1])


def test_decide_stages_equal_decide_with_the_mesh_rule():
    """The two stages over a MAX reduction equal the single-device
    ``core.decide`` and ``core.settle`` on every rank's columns in one
    carry, with pmax's rule on more than one rank: a rank whose max is NaN
    is dropped."""
    rng = np.random.default_rng(18)
    for nranks in (1, 2, 4):
        taus = [rng.random((2, 8)) for _ in range(nranks)]
        taus[0][0, 3] = np.nan
        res2s = [rng.random((2, 8)) for _ in range(nranks)]
        res2s[-1][1, 5] = np.nan
        stats = [rng.choice([0, 1, -1, -2], (2, 8)).astype(np.int32)
                 for _ in range(nranks)]
        inv = torch.ones((2, 8), dtype=torch.float64)
        maxit = torch.tensor(9, dtype=torch.int32)
        tol2 = torch.tensor(0.5, dtype=torch.float64)
        bound2 = torch.tensor(2.0, dtype=torch.float64)
        cs = [_carry(t, s, 3, 1e-3) for t, s in zip(taus, stats)]
        parts = [core.decide_local(c, inv, nranks == 1) for c in cs]
        got = core.decide_finish(cs[0], _reduced(parts), maxit)
        locals_ = [core.settle_local(c, torch.from_numpy(r), tol2,
                                     nranks == 1)
                   for c, r in zip(cs, res2s)]
        settled = core.settle_finish(cs[0], locals_[0][0],
                                     _reduced([p for _, p in locals_]),
                                     bound2, tol2)

        def joined(vs):       # pmax drops a rank whose local max is NaN
            return np.concatenate([
                np.full_like(v, -np.inf) if nranks > 1 and np.isnan(v).any()
                else v for v in vs], axis=1)

        one = _carry(joined(taus), np.concatenate(stats, axis=1), 3, 1e-3)
        want = core.decide(one, torch.ones(one.tau.shape,
                                           dtype=torch.float64), maxit)
        assert int(got[0]) == int(want[0]) and bool(got[2]) == bool(want[2])
        assert _bits_equal(got[1], want[1])
        want = core.settle(one, torch.from_numpy(joined(res2s)), bound2,
                           tol2)
        assert _bits_equal(settled.residual2, want.residual2)
        assert _bits_equal(settled.target_bound2, want.target_bound2)
        assert (int(settled.stop_code), int(settled.iters_needed)) == (
            int(want.stop_code), int(want.iters_needed))

"""The loop in carry form (``core.init_carry`` / ``step`` / ``decide`` /
``probe_residual`` / ``settle``) under the plain driver, against the JAX
package's ``while_loop`` on the CPU, and the graph driver's CPU-testable
parts (``graphloop.record`` under a capture that captures nothing, the
launch counters' host side, the routing, ``graphloop.refill``).

The parity cases hand the JAX plan and v3 to the port
(``convert.plan_from_numpy``, ``Solver(..., v3=..., device="cpu")``) and run
JAX's 'xla' engine with TFQ_XLA_OZ=0 and its 'dense' engine with
TFQ_Z_OZAKI=0 (plain float64).  JAX's probe count is read from the
``SolveResult`` its ``_finish_solve`` receives."""

import contextlib
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import make_random_problem
import tfqmrgpu_tpu_torch as tt
from tfqmrgpu_tpu import core as jcore
from tfqmrgpu_tpu import solver as jsolver
from tfqmrgpu_tpu_torch import convert, core, graphloop, launch_counts
from tfqmrgpu_tpu_torch.bsr import Bsr as TBsr
from tfqmrgpu_tpu_torch.errors import Status
from tfqmrgpu_tpu_torch.ops import decisions, linalg

torch.set_num_threads(2)

EPS = decisions.EPSILON


def _port(*bsrs):
    return [TBsr(m.nrows, m.ncols, m.rowptr, m.colind, m.data, m.name)
            for m in bsrs]


def _jax_solver(monkeypatch, a, x, b, precision, engine):
    """A JAX Solver whose solves record their ``SolveResult.n_probes``."""
    monkeypatch.setenv("TFQ_XLA_OZ", "0")
    monkeypatch.setenv("TFQ_Z_OZAKI", "0")
    js = jsolver.Solver(a, x, b, precision=precision, engine=engine)
    js.probes = []
    finish = js._finish_solve

    def record(result, max_iterations):
        js.probes.append(int(result.n_probes))
        return finish(result, max_iterations)

    js._finish_solve = record
    return js


def _port_solver(js, a, x, b, precision, engine, v3=None):
    jp = js.plan
    if v3 is None:
        v3 = jcore.make_shadow_vector(jp.nnzb_x, js.lm, js.ln)
    plan = convert.plan_from_numpy(
        **{k: getattr(jp, k) for k in convert.PLAN_FIELDS}, device="cpu")
    ts = tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                   plan=plan, v3=tuple(np.asarray(v) for v in v3),
                   device="cpu")
    assert ts.engine == engine
    return ts


def _same(jinfo, tinfo, js, ts, tol_x, probes=True):
    assert tinfo.iterations_needed == jinfo.iterations_needed
    assert tinfo.return_status == jinfo.return_status
    assert np.array_equal(tinfo.rhs_status, np.asarray(jinfo.rhs_status))
    if probes:
        assert tinfo.n_probes == js.probes[-1]
    want, got = js.get_matrix("X"), ts.get_matrix("X")
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= tol_x * scale


def _problem(seed, mb=12, lm=4, ln=8, ncols=3, **kw):
    return make_random_problem(np.random.default_rng(seed), mb=mb, lm=lm,
                               ln=ln, ncols=ncols, **kw)


# ------------------------------------------------------ parity with JAX

@pytest.mark.parametrize("case", [
    "converges", "cap", "one_iteration", "all_breakdown", "zero_column",
    "trivial_rhs", "initial_guess", "dense_c"])
def test_carry_loop_matches_jax(monkeypatch, case):
    precision, engine, jengine = "z", "pairs", "xla"
    tol, maxit, x0, trivial, nan_v3 = 1e-10, 200, None, False, False
    a, x, b = _problem(3)
    if case == "cap":                   # stops at the cap, after its probe
        tol, maxit = 1e-14, 4
    elif case == "one_iteration":
        maxit = 1
    elif case == "all_breakdown":
        # a NaN shadow vector: <v3, v5> and <v3, v4> are not finite in
        # every column (status -1, then -2), and tau stays > 0 (no -3)
        nan_v3 = True
    elif case == "zero_column":
        # one RHS of B is zero: 1/|B|^2 is 0 there, as in JAX's panel
        # engines (its block list divides by zero)
        data = b.data.copy()
        data[:, :, 0] = 0.0
        b = b.with_data(data)
        engine = jengine = "dense"
    elif case == "trivial_rhs":
        a, x, b = _problem(10, mb=10, ln=8, ncols=2, x_fill=1.0)
        trivial = True
    elif case == "initial_guess":
        rng = np.random.default_rng(9)
        x0 = 0.01 * (rng.standard_normal((x.nnzb, 4, 8))
                     + 1j * rng.standard_normal((x.nnzb, 4, 8)))
    elif case == "dense_c":             # the panel route in complex64
        precision, engine, jengine, tol = "c", "dense", "dense", 1e-5
    js = _jax_solver(monkeypatch, a, x, b, precision, jengine)
    v3 = None
    if nan_v3:
        js._v3 = v3 = tuple(jnp.full_like(v, jnp.nan) for v in js._v3)
    ts = _port_solver(js, a, x, b, precision, engine, v3)
    if x0 is not None:
        js.set_matrix("X", x0)
        ts.set_matrix("X", x0)
    jinfo = js.solve(tolerance=tol, max_iterations=maxit,
                     rhs_trivial=trivial)
    tinfo = ts.solve(tolerance=tol, max_iterations=maxit,
                     rhs_trivial=trivial)
    _same(jinfo, tinfo, js, ts, 1e-10 if precision == "z" else 1e-4)
    want = {"cap": Status.MAX_ITERATIONS, "all_breakdown": Status.BREAKDOWN}
    assert tinfo.return_status == want.get(case, Status.SUCCESS) or (
        case == "one_iteration"
        and tinfo.return_status == Status.MAX_ITERATIONS)
    if case in ("cap", "one_iteration"):
        assert tinfo.n_probes >= 1        # the probe at it >= maxit
    if case == "all_breakdown":
        assert tinfo.n_probes == 0 and tinfo.iterations_needed == 200
        assert set(np.unique(tinfo.rhs_status)) == {-2}
    if case == "zero_column":           # its residual is exactly zero
        assert np.all(tinfo.rhs_status[:, 0] == 1)


def test_checkpointed_chunks_match_jax(monkeypatch, tmp_path):
    a, x, b = _problem(5)
    js = _jax_solver(monkeypatch, a, x, b, "z", "xla")
    ts = _port_solver(js, a, x, b, "z", "pairs")
    jinfo = js.solve_checkpointed(tolerance=1e-10, max_iterations=60,
                                  chunk=4)
    tinfo = ts.solve_checkpointed(tolerance=1e-10, max_iterations=60,
                                  chunk=4, state_path=str(tmp_path / "st"))
    assert tinfo.iterations_needed == jinfo.iterations_needed
    assert tinfo.return_status == jinfo.return_status == Status.SUCCESS
    _same(jinfo, tinfo, js, ts, 1e-10)


# ------------------------------------- decide / settle against numpy (JAX)

def np_decide(tau, inv_bn2, status, it, maxit, target_bound2, stop_code):
    """tfqmrgpu_tpu/core.py:188-193 in numpy."""
    max_bound2 = np.max(tau * inv_bn2) * float(2 * it + 1)
    broke = (status == -1) | (status == -2)
    all_broke = bool(np.all(broke))
    probe = ((max_bound2 <= target_bound2) or it >= maxit) and not all_broke
    return (2 if all_broke else stop_code), max_bound2, probe


def np_probe(res2, status, tol2, max_bound2, stop_code, iters_needed,
             n_probes, it):
    """tfqmrgpu_tpu/core.py:195-211 (``do_probe``) in numpy."""
    max_res2 = np.maximum(np.max(res2), EPS)
    is_done = bool(np.all((res2 <= tol2) | (status != 0)))
    status = np.where(res2 <= 0, 1, status)
    tb2 = (max_bound2 / max_res2) * tol2
    return (status, tb2, max_res2, 1 if is_done else stop_code,
            it if is_done else iters_needed, n_probes + 1)


SPECIAL = [0.0, EPS, 2 * EPS, 0.5 * EPS, 1e-300, 1.0, 1e30, np.inf,
           np.nan]
values = st.one_of(st.sampled_from(SPECIAL),
                   st.floats(0.0, 1e6, allow_nan=False))


def _carry(tau, status, it, target_bound2, stop_code=0, iters_needed=50,
           n_probes=3, residual2=1e30):
    s = lambda v, dt: torch.tensor(v, dtype=dt)      # noqa: E731
    z = torch.zeros(2)
    return core.Carry(
        it=s(it, torch.int32), v1=(z, z), v4=(z, z), v5=(z, z), v6=(z, z),
        v7=(z, z), v8=(z, z), rho=(z, z), eta=(z, z),
        tau=torch.tensor(tau, dtype=torch.float64),
        var=torch.zeros_like(torch.tensor(tau)),
        status=torch.tensor(status, dtype=torch.int32),
        target_bound2=s(target_bound2, torch.float64),
        residual2=s(residual2, torch.float64),
        stop_code=s(stop_code, torch.int32),
        iters_needed=s(iters_needed, torch.int32),
        n_probes=s(n_probes, torch.int32))


def _bits_equal(a, b) -> bool:
    a, b = float(a), float(b)
    return (np.isnan(a) and np.isnan(b)) or (
        np.float64(a).view(np.int64) == np.float64(b).view(np.int64))


@settings(max_examples=150, deadline=None)
@given(tau=st.lists(values, min_size=1, max_size=12),
       inv=st.lists(st.sampled_from([0.0, 1.0, 0.5, 3.0, 1e-300]),
                    min_size=12, max_size=12),
       status=st.lists(st.sampled_from([0, 1, -1, -2, -3]), min_size=12,
                       max_size=12),
       it=st.integers(1, 9), maxit=st.integers(1, 9),
       tie=st.sampled_from(["tie", "below", "above", "free"]),
       target=values)
def test_decide_matches_numpy(tau, inv, status, it, maxit, tie, target):
    with np.errstate(all="ignore"):
        _decide_case(tau, inv, status, it, maxit, tie, target)


def _decide_case(tau, inv, status, it, maxit, tie, target):
    n = len(tau)
    tau = np.asarray(tau, np.float64).reshape(1, n)
    inv = np.asarray(inv[:n], np.float64).reshape(1, n)
    status = np.asarray(status[:n], np.int32).reshape(1, n)
    bound = np.max(tau * inv) * float(2 * it + 1)
    if tie != "free" and np.isfinite(bound):
        target = {"tie": bound, "below": np.nextafter(bound, -np.inf),
                  "above": np.nextafter(bound, np.inf)}[tie]
    want = np_decide(tau, inv, status, it, maxit, target, 0)
    c = _carry(tau, status, it, target)
    got = core.decide(c, torch.from_numpy(inv),
                      torch.tensor(maxit, dtype=torch.int32))
    assert int(got[0]) == want[0]
    assert _bits_equal(got[1], want[1])
    assert bool(got[2]) == want[2]


@settings(max_examples=150, deadline=None)
@given(res2=st.lists(st.one_of(values, st.just(-0.0)), min_size=1,
                     max_size=12),
       status=st.lists(st.sampled_from([0, 1, -1, -2, -3]), min_size=12,
                       max_size=12),
       tol2=st.sampled_from([0.0, 1e-20, 1e-10, 1.0, EPS]),
       max_bound2=values, it=st.integers(1, 50),
       stop_code=st.sampled_from([0, 2]))
def test_settle_matches_numpy(res2, status, tol2, max_bound2, it, stop_code):
    with np.errstate(all="ignore"):
        _settle_case(res2, status, tol2, max_bound2, it, stop_code)


def _settle_case(res2, status, tol2, max_bound2, it, stop_code):
    n = len(res2)
    res2 = np.asarray(res2, np.float64).reshape(1, n)
    status = np.asarray(status[:n], np.int32).reshape(1, n)
    want = np_probe(res2, status, tol2, max_bound2, stop_code, 50, 3, it)
    c = _carry(np.ones((1, n)), status, it, 0.0, stop_code=stop_code)
    got = core.settle(c, torch.from_numpy(res2),
                      torch.tensor(max_bound2, dtype=torch.float64),
                      torch.tensor(tol2, dtype=torch.float64))
    assert np.array_equal(got.status.numpy(), want[0])
    assert _bits_equal(got.target_bound2, want[1])
    assert _bits_equal(got.residual2, want[2])
    assert (int(got.stop_code), int(got.iters_needed), int(got.n_probes)) \
        == want[3:]
    assert np.array_equal(c.status.numpy(), status)   # the input stays


@pytest.mark.parametrize("it,maxit,stop,want", [
    (0, 5, 0, True), (4, 5, 0, True), (5, 5, 0, False), (6, 5, 0, False),
    (1, 5, 1, False), (1, 5, 2, False), (0, 0, 0, False)])
def test_continue_predicate(it, maxit, stop, want):
    c = _carry(np.ones((1, 2)), np.zeros((1, 2)), it, 0.0, stop_code=stop)
    m = torch.tensor(maxit, dtype=torch.int32)
    assert bool(graphloop.LoopControl.running(c, m)) == want
    with pytest.raises(tt.TfqmrgpuError):   # no kernel for a CPU tensor
        graphloop.LoopControl.cont(c, m, torch.zeros((), dtype=torch.int32))


# ------------------------------------------- the graph driver on the CPU

class Counted:
    launches = 0


def _blocks_loop(seed=4, tol=1e-10, maxit=200, passes=False):
    """The block-list loop's inputs on the CPU with a multiply that counts
    its calls in ``Counted.launches``; with ``passes`` the vector passes
    are ``linalg.VectorPasses``' (their plain versions, in place)."""
    a, x, b = _problem(seed)
    ts = tt.Solver(*_port(a, x, b), precision="z", engine="xla",
                   device="cpu")
    mult = ts._multiply

    def multiply(v):
        Counted.launches += 1
        return mult(v)

    cols, subset = ts._cols, ts.plan.subset
    prim = core.TfqmrPrimitives(
        multiply=multiply, dotp=lambda p, q: linalg.dotp(p, q, cols),
        nrm2=lambda p: linalg.nrm2(p, cols),
        axpy=lambda y, p, s: linalg.axpy(y, p, s, cols.colindx),
        xpay=lambda y, s, p: linalg.xpay(y, s, p, cols.colindx),
        add_rhs=lambda v, bb, s: linalg.add_rhs(v, bb, s, subset))
    if passes:
        vp = linalg.VectorPasses(cols, subset)
        prim = dataclasses.replace(prim, dotp=vp.dotp, nrm2=vp.nrm2,
                                   axpy=vp.axpy, xpay=vp.xpay,
                                   add_rhs=vp.add_rhs)
    v2 = ts._b
    shape = (ts.plan.nnzb_x, ts.lm, ts.ln)
    z = (torch.zeros(shape, dtype=torch.float64),
         torch.zeros(shape, dtype=torch.float64))
    v5 = prim.add_rhs(z, v2, 1.0)
    tau0 = prim.nrm2(v5)
    ins = graphloop.LoopInputs(
        v2=v2, v3=ts._v3, v5_init=v5, tau0=tau0,
        inv_bn2=core.inverse_norms(tau0),
        tol2=torch.tensor(tol ** 2, dtype=torch.float64),
        maxit=torch.tensor(maxit, dtype=torch.int32))
    return prim, ins, tol, maxit


@pytest.mark.parametrize("cls,name,slots", [
    ("PairPlanMultiply", "launches", ("k1",)),
    ("LoopControl", "launches", ("loop_decide", "loop_settle",
                                 "loop_continue", "loop_decide_local",
                                 "loop_decide_finish", "loop_settle_local",
                                 "loop_settle_finish")),
    ("VectorPasses", "launches", ("vec_axpay", "vec_add_rhs", "vec_partials",
                                  "vec_column_sums"))])
def test_launch_counters_read_and_reset(cls, name, slots):
    """A wrapper's counter attribute reads and resets its slots of
    ``launch_counts``; without a card (the CPU) no counter is made and
    every one reads 0, a reset to another value than 0 raises, and the
    plain versions on CPU tensors count nothing."""
    from tfqmrgpu_tpu_torch.ops.pairpanel import PairPlanMultiply

    klass = {"PairPlanMultiply": PairPlanMultiply,
             "LoopControl": graphloop.LoopControl,
             "VectorPasses": linalg.VectorPasses}[cls]
    assert launch_counts._counts == {}       # no card: nothing was made
    assert getattr(klass, name) == 0
    setattr(klass, name, 0)
    assert all(launch_counts.read()[s] == 0 for s in slots)
    with pytest.raises(ValueError):
        setattr(klass, name, 3)
    with pytest.raises(AttributeError):
        getattr(klass, "no_such_counter")
    with launch_counts.uncounted():
        assert launch_counts.pointer(torch.device("cuda", 0), slots[0]) \
            is None
    prim, ins, tol, maxit = _blocks_loop(passes=True)
    core.plain_loop(prim, ins.v2, ins.v3, ins.v5_init, ins.tau0,
                    ins.inv_bn2, tol ** 2, maxit, torch.float64)
    assert getattr(klass, name) == 0 and launch_counts._counts == {}


class DryCapture:
    """A capture that captures nothing: ``record`` under it runs the loop's
    outer part, one iteration and one probe eagerly."""

    def handle(self):
        return None

    @contextlib.contextmanager
    def node(self, handle, kind: int):
        yield


class PlainControl:
    """``graphloop.LoopControl`` on CPU tensors: its plain versions, in
    place."""

    @staticmethod
    def decide(c, inv_bn2, maxit, max_bound2, probe, handle=None):
        stop_code, bound2, go = core.decide(c, inv_bn2, maxit)
        c.stop_code.copy_(stop_code)
        max_bound2.copy_(bound2)
        probe.copy_(go)

    @staticmethod
    def settle(c, res2, max_bound2, tol2):
        s = core.settle(c, res2, max_bound2, tol2)
        for name in ("status", "residual2", "target_bound2", "stop_code",
                     "iters_needed", "n_probes"):
            getattr(c, name).copy_(getattr(s, name))

    @staticmethod
    def cont(c, maxit, go=None, handle=None):
        pass


def test_recorded_loop_is_one_iteration_of_the_plain_loop(monkeypatch):
    """Under a capture that captures nothing the recorded graph runs its
    outer part, one iteration and its probe: at maxit 1 that is the whole
    loop, and it equals the plain driver's to the bit."""
    monkeypatch.setattr(graphloop, "LoopControl", PlainControl)
    prim, ins, tol, _ = _blocks_loop(maxit=1)
    want = core.plain_loop(prim, ins.v2, ins.v3, ins.v5_init, ins.tau0,
                           ins.inv_bn2, tol ** 2, 1, torch.float64)
    v5_before = ins.v5_init[0].clone()
    c, state = graphloop.record(prim, ins, torch.float64, DryCapture())
    stop, iters_needed, it, n_probes, residual2 = state.tolist()
    got = core.solve_result(c, stop, iters_needed, n_probes, residual2)
    assert it == 1
    assert (got.return_status, got.iterations, got.n_probes) == (
        want.return_status, want.iterations, want.n_probes)
    assert got.residuum == want.residuum
    assert torch.equal(got.x[0], want.x[0]) and torch.equal(got.x[1],
                                                            want.x[1])
    assert torch.equal(got.rhs_status, want.rhs_status)
    assert torch.equal(ins.v5_init[0], v5_before)   # the inputs stay


def test_in_place_passes_leave_one_vector_copy(monkeypatch):
    """With ``VectorPasses`` (in place) the recorded step writes v1, v4,
    v5, v6 and v7 into the carry's own planes, so ``record``'s copies of
    them have the target as their source and launch nothing; v8, the
    multiply's output, is the one X-shaped copy.  The loop is the plain
    driver's to the bit, and the passes' plain driver takes the
    iterations and probes of ``linalg``'s, X within 1e-10."""
    monkeypatch.setattr(graphloop, "LoopControl", PlainControl)
    prim, ins, tol, _ = _blocks_loop(maxit=1, passes=True)
    step, seen = core.step, []

    def spy(prim, c, v3, dt):
        before = {f: [t.data_ptr() for t in getattr(c, f)]
                  for f in ("v1", "v4", "v5", "v6", "v7", "v8")}
        n = step(prim, c, v3, dt)
        seen.append((before, c, n))
        return n

    monkeypatch.setattr(core, "step", spy)
    c, state = graphloop.record(prim, ins, torch.float64, DryCapture())
    before, carry, n = seen[-1]
    assert carry is c
    for f in ("v1", "v4", "v5", "v6", "v7"):
        assert all(a is b for a, b in zip(getattr(n, f), getattr(c, f)))
        assert [t.data_ptr() for t in getattr(n, f)] == before[f]
    assert all(a.data_ptr() != p for a, p in zip(n.v8, before["v8"]))
    monkeypatch.setattr(core, "step", step)
    want = core.plain_loop(prim, ins.v2, ins.v3, ins.v5_init, ins.tau0,
                           ins.inv_bn2, tol ** 2, 1, torch.float64)
    assert torch.equal(c.v1[0], want.x[0]) and torch.equal(c.v1[1],
                                                           want.x[1])
    runs = []
    for passes in (False, True):
        prim, ins, tol, maxit = _blocks_loop(passes=passes)
        runs.append(core.plain_loop(prim, ins.v2, ins.v3, ins.v5_init,
                                    ins.tau0, ins.inv_bn2, tol ** 2, maxit,
                                    torch.float64))
    ref, got = runs
    assert (got.return_status, got.iterations, got.n_probes) == (
        ref.return_status, ref.iterations, ref.n_probes) and ref.iterations > 5
    scale = max(float(t.abs().max()) for t in ref.x)
    assert max(float((g - r).abs().max()) for g, r in zip(got.x, ref.x)) \
        <= 1e-10 * scale


def test_loop_inputs_buffers_and_fill():
    _, ins, _, _ = _blocks_loop()
    buf = ins.buffers()
    buf.fill(ins)
    for mine, theirs in zip(buf.values(), ins.values()):
        for m, t in zip(graphloop._leaves(mine), graphloop._leaves(theirs)):
            assert m is not t and torch.equal(m, t) and m.is_contiguous()


def test_tfqmr_loop_routes(monkeypatch):
    """CPU tensors take the plain driver; any other device goes to the
    graph driver (meta tensors stand in for the card), with the Solver's
    graphs and key, the sharded primitives too."""
    calls = []
    plain = core.plain_loop

    def fake_run(graphs, key, *args):
        calls.append(("graph", graphs, key))
        return "graph"

    def fake_plain(*args):
        calls.append(("plain", args[5].device.type))
        return plain(*args) if args[5].device.type == "cpu" else "plain"

    monkeypatch.setattr(graphloop, "run_graph", fake_run)
    monkeypatch.setattr(core, "plain_loop", fake_plain)
    prim, ins, tol, maxit = _blocks_loop()
    args = (ins.v2, ins.v3, ins.v5_init, ins.tau0, ins.inv_bn2, tol, maxit,
            torch.float64)
    assert core.tfqmr_loop(prim, *args).return_status == Status.SUCCESS
    meta = torch.empty((3, 8), dtype=torch.float64, device="meta")
    graphs = graphloop.LoopGraphs()
    margs = (ins.v2, ins.v3, ins.v5_init, ins.tau0.to("meta"),
             meta, tol, maxit, torch.float64)
    assert core.tfqmr_loop(prim, *margs, graphs=graphs,
                           key=("k",)) == "graph"
    # the sharded primitives take the same routes: the graph on the card
    from tfqmrgpu_tpu_torch.parallel.sharded import sharded_primitives

    class Mesh:
        ranks = 2
        psum = reduce_max = staticmethod(lambda t: t)

    sp = sharded_primitives(Mesh(), prim)
    assert isinstance(sp.mesh, Mesh) and prim.mesh is None
    assert not hasattr(sp, "host_loop")
    assert core.tfqmr_loop(sp, *margs, graphs=graphs,
                           key=("s",)) == "graph"
    assert core.tfqmr_loop(sp, *args).return_status == Status.SUCCESS
    assert calls == [("plain", "cpu"), ("graph", graphs, ("k",)),
                     ("graph", graphs, ("s",)), ("plain", "cpu")]


class FakeGraph:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


@pytest.mark.parametrize("change", ["A", "v3"])
def test_solver_drops_its_graphs(monkeypatch, change):
    """A new v3, or a new A that the multiply cannot take in place, drops
    the Solver's graphs."""
    from tfqmrgpu_tpu_torch import solver as tsolver

    a, x, b = _problem(6)
    s = tt.Solver(*_port(a, x, b), precision="z", engine="pairs",
                  device="cpu")
    info = s.solve(tolerance=1e-10)
    assert len(s.loop_graphs) == 0         # the CPU keeps no graph
    g = s.loop_graphs._graphs[("k",)] = FakeGraph()
    if change == "A":
        monkeypatch.setattr(tsolver, "refill", lambda old, new: False)
        s.set_matrix("A", a.data)
    else:
        s.set_shadow_vector(*(v.cpu().numpy() for v in s._v3))
    assert g.closed and len(s.loop_graphs) == 0
    again = s.solve(tolerance=1e-10)
    assert again.iterations_needed == info.iterations_needed


@pytest.mark.parametrize("precision,engine,env", [
    ("z", "xla", {}), ("z", "dense", {}), ("c", "pallas", {}),
    ("z", "pairs", {}), ("c", "pairs", {}),
    ("c", "pallas", {"TFQ_PALLAS_MM_PREC": "bf16x3"}),
    ("c", "pairs", {"TFQ_PAIRS_MM_PREC": "bf16x3"})])
def test_solver_keeps_its_graphs_for_a_new_a(monkeypatch, precision, engine,
                                             env):
    """A new A of the plan goes into the multiply the graphs captured
    (``graphloop.refill``): the graphs and the multiply stay, and the next
    solve equals a fresh Solver's to the bit."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    lm = 16 if env else 4
    a, x, b = _problem(8, lm=lm, ln=2 * lm)
    tol = 1e-5 if precision == "c" else 1e-10
    s = tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                  device="cpu")
    s.solve(tolerance=tol)
    old = s._multiply
    g = s.loop_graphs._graphs[("k",)] = FakeGraph()
    a2 = 1.5 * a.data + 0.1 * np.random.default_rng(9).standard_normal(
        a.data.shape)
    s.set_matrix("A", a2)
    assert s._multiply is old and not g.closed and len(s.loop_graphs) == 1
    fresh = tt.Solver(*_port(a, x, b), precision=precision, engine=engine,
                      device="cpu")
    fresh.set_matrix("A", a2)
    got, want = s.solve(tolerance=tol), fresh.solve(tolerance=tol)
    assert got.iterations_needed == want.iterations_needed
    assert np.array_equal(s.get_matrix("X"), fresh.get_matrix("X"))


def test_refill_refuses_other_tables():
    """``refill`` copies floating-point tensors only where everything else
    is the same; else it returns False and leaves the old object as it
    was."""

    class M:
        def __init__(self, a, idx, n, extra=None):
            self.a, self.idx, self.n, self.extra = a, idx, n, extra

    a1, a2 = torch.zeros(3, dtype=torch.float64), torch.ones(3)
    idx = torch.arange(3)
    cases = [M(a2.double(), idx + 1, 2), M(a2.double(), idx, 3),
             M(a2, idx, 2), M(a2.double()[None], idx, 2),
             M(a2.double(), idx, 2, extra=object())]
    for new in cases:
        old = M(a1.clone(), idx.clone(), 2, extra=new.extra and object())
        assert not graphloop.refill(old, new)
        assert torch.equal(old.a, a1)
    old = M(a1.clone(), idx.clone(), 2, extra=[1, 2])
    new = M(a2.double(), idx.clone(), 2, extra=[])  # lazy in new: kept
    assert graphloop.refill(old, new)
    assert torch.equal(old.a, a2.double()) and old.extra == [1, 2]


def test_packed_primitives_hold_no_vector():
    """The packed engine's primitives are made once an A and take B with
    each ``add_rhs``: a solve after set_matrix('B') uses the new B."""
    a, x, b = _problem(7, lm=4, ln=4, ncols=2)
    s = tt.Solver(*_port(a, x, b), precision="c", engine="pairs",
                  device="cpu")
    prim = s._fused_primitives()
    assert s._fused_primitives() is prim
    first = s.solve(tolerance=1e-5)
    x1 = s.get_matrix("X")
    s.set_matrix("B", 2.0 * b.data)
    assert s._fused_primitives() is prim
    second = s.solve(tolerance=1e-5)
    assert second.iterations_needed == first.iterations_needed
    np.testing.assert_allclose(s.get_matrix("X"), 2.0 * x1, rtol=1e-4,
                               atol=1e-4 * np.max(np.abs(x1)))
    s.set_matrix("A", a.data)
    assert s._fused_primitives() is not prim


def test_carry_fields_match_jax():
    """The carry holds the JAX carry's fields (core._Carry)."""
    assert [f.name for f in dataclasses.fields(core.Carry)] == [
        f.name for f in dataclasses.fields(jcore._Carry)]

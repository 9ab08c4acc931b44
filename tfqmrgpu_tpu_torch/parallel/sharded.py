"""Sharded tfQMR solve over ``torch.distributed``: the block-list engine.

Counterpart of ``tfqmrgpu_tpu/parallel/sharded.py``.  The JAX package runs
one process over a device mesh inside ``shard_map``; this package runs one
process per rank and one device per rank, SPMD: every rank calls the same
entry point with the same host inputs, holds one shard on its device and
returns the full result.  The loop body is the single-device one
(``core.tfqmr_loop``) with sharded primitives:

* **SpMM**: each (row, col) shard owns the pairs of its Y blocks.  The X
  working set is completed by one ``all_gather`` of the local X shard over
  the "rows" axis (the halo exchange, ``Halo``), and the shard's pair table
  runs against the gathered X through the pair-plan kernel K1
  (``ops/pairpanel.PairPlanMultiply`` over a ``PairTable`` whose X side is
  the gathered array); on the CPU its plain version runs.
* **dotp/nrm2**: local per-column sums + one ``all_reduce(SUM)`` over
  "rows" per call, on the float64 [ncmax, LN] partials (re and im of a
  dotp in one tensor).
* **scalar recurrences**: replicated per column shard ([ncmax, LN] each).
* **convergence control**: the host-decision scalars take ``all_reduce``
  MAX (and MIN for "all") over every rank of the mesh before the host
  reads them (``TfqmrPrimitives.allmax`` / ``alland``), so probe timing and
  stopping agree on every rank and with one device.

The collectives follow the tensors' device: NCCL on the card, gloo on the
CPU.  ``Mesh.calls`` counts them by kind.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import core
from ..core import TfqmrPrimitives
from ..errors import Status, TfqmrgpuError, encode_status
from ..ops import linalg
from ..ops.pairpanel import PairPlanMultiply, PairTable
from .multihost import gather_global
from .partition import RowPartition, unshard_blocks_array

# the newer name of all_gather_into_tensor, where torch has it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

AXES = ("rows", "cols")


def _backend_fits(backend: str, device: torch.device) -> bool:
    return ("nccl" if device.type == "cuda" else "gloo") in str(backend)


class Mesh:
    """This rank's place in a grid of pr x pc ranks, one device each: the
    counterpart of the JAX ``Mesh(devices.reshape(pr, pc), ("rows",
    "cols"))``.  Rank ``r*pc + c`` holds shard (r, c).

    Three process groups carry the collectives: ``rows``, the pr ranks
    along the "rows" axis (this rank's column: the halo all_gather and the
    sums of the per-column reductions), ``cols``, the pc ranks along the
    "cols" axis (this rank's row), and ``group``, every rank of the mesh
    (the convergence maxima and the gathers of the result).  A rank beyond
    pr*pc holds no shard: its ``row`` is None.  ``calls`` counts the
    collectives this rank issued, by kind.
    """

    def __init__(self, pr: int, pc: int, row: Optional[int],
                 col: Optional[int], rows, cols, group,
                 device: torch.device):
        self.pr, self.pc = int(pr), int(pc)
        self.row, self.col = row, col
        self.device = torch.device(device)
        self._groups = {("rows",): rows, ("cols",): cols, AXES: group}
        if self.member:
            for g in self._groups.values():
                backend = dist.get_backend(g)
                if not _backend_fits(backend, self.device):
                    raise TfqmrgpuError(
                        encode_status(Status.NO_IMPLEMENTATION),
                        f"a {backend} process group cannot run the "
                        f"collectives of {self.device} tensors: NCCL on "
                        "the card, gloo on the CPU")
        self.calls = collections.Counter()

    @property
    def member(self) -> bool:
        return self.row is not None

    @property
    def shape(self) -> dict:
        return {"rows": self.pr, "cols": self.pc}

    def require_member(self):
        if not self.member:
            raise TfqmrgpuError(
                encode_status(Status.NO_INFO_PASSED),
                f"rank {dist.get_rank()} holds no shard of a {self.pr} x "
                f"{self.pc} mesh")

    def _size(self, axes: tuple) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   axes: tuple = ("rows",)) -> torch.Tensor:
        """``out`` [n, *inp.shape] := ``inp`` of the n ranks along ``axes``,
        in their order (``AXES``: rank r*pc + c at r*pc + c)."""
        # the concatenated form [n*inp.shape[0], ...], which gloo requires
        _all_gather(out.view((-1,) + tuple(inp.shape[1:])), inp,
                    group=self._groups[tuple(axes)])
        self.calls["all_gather"] += 1
        return out

    def all_gather_async(self, out: torch.Tensor, inp: torch.Tensor,
                         axes: tuple = ("rows",)):
        """``all_gather`` issued asynchronously: ``out`` [n*inp.shape[0],
        ...] is written after the returned work handle's ``wait()``, which
        on NCCL orders NCCL's stream before the current one (what is
        launched on the current stream in between overlaps the
        collective).  ``inp`` must not change before then."""
        work = _all_gather(out, inp, group=self._groups[tuple(axes)],
                           async_op=True)
        self.calls["all_gather"] += 1
        return work

    def neighbour_exchange(self, send_up: torch.Tensor,
                           recv_below: torch.Tensor, send_down: torch.Tensor,
                           recv_above: torch.Tensor) -> list:
        """The edge exchange of a neighbour halo over the "rows" axis (the
        JAX package's two ``ppermute`` calls): shard r sends ``send_up`` to
        shard r + 1, which receives it in ``recv_below``, and ``send_down``
        to shard r - 1, which receives it in ``recv_above``.  Empty tensors
        are not sent; the first and last shards post nothing past the edge,
        so their edge buffers keep what they held.  Every rank posts its
        operations in the same order.  Returns the work handles, to
        ``wait()`` before the buffers are read."""
        r, pr, pc, col = self.row, self.pr, self.pc, self.col
        group = self._groups[("rows",)]
        ops = []
        for send, recv, to in ((send_up, recv_below, 1),
                               (send_down, recv_above, -1)):
            if send.numel() == 0:
                continue
            if 0 <= r + to < pr:
                ops.append(dist.P2POp(dist.isend, send, (r + to) * pc + col,
                                      group))
            if 0 <= r - to < pr:
                ops.append(dist.P2POp(dist.irecv, recv, (r - to) * pc + col,
                                      group))
        self.calls["neighbour_exchange"] += 1
        return dist.batch_isend_irecv(ops) if ops else []

    def gather(self, t: torch.Tensor, axes: tuple = AXES) -> torch.Tensor:
        """``t`` of every rank along ``axes``, stacked on new leading axes
        of those sizes (shapes must agree across the ranks)."""
        t = t.contiguous()
        out = t.new_empty((self._size(axes),) + tuple(t.shape))
        self.all_gather(out, t, axes)
        return out.reshape(tuple(self.shape[a] for a in axes)
                           + tuple(t.shape))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the "rows" axis, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._groups[("rows",)])
        self.calls["all_reduce"] += 1
        return t

    def allmax(self, s: torch.Tensor) -> torch.Tensor:
        """The max of a scalar over every rank of the mesh."""
        t = s.reshape(1).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._groups[AXES])
        self.calls["all_reduce"] += 1
        return t[0]

    def alland(self, b: torch.Tensor) -> torch.Tensor:
        """The "all" of a bool scalar over every rank of the mesh."""
        t = b.reshape(1).to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._groups[AXES])
        self.calls["all_reduce"] += 1
        return t[0].bool()


def make_mesh(pr: int, pc: int = 1, device=None) -> Mesh:
    """The (pr, pc) grid over ranks 0 .. pr*pc-1 of the process group, on
    this rank's device (``multihost.local_device``: the card
    cuda:LOCAL_RANK unless ``device`` is given).  Collective over every
    rank of the world, which must all call it with the same arguments (it
    creates the groups with ``dist.new_group``, in one order).  Without an
    initialized process group it initializes one (``multihost.initialize``:
    under ``torchrun`` from its environment, else a world of one)."""
    from .multihost import initialize

    dev = initialize(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = int(pr) * int(pc)
    if n < 1 or world < n:
        raise ValueError(f"need {n} ranks, have {world}")

    def group(ranks):
        return (dist.group.WORLD if len(ranks) == world
                else dist.new_group(ranks))

    everyone = group(list(range(n)))
    rows = [group([r * pc + c for r in range(pr)]) for c in range(pc)]
    cols = [group([r * pc + c for c in range(pc)]) for r in range(pr)]
    if rank >= n:
        return Mesh(pr, pc, None, None, None, None, None, dev)
    r, c = divmod(rank, pc)
    return Mesh(pr, pc, r, c, rows[c], cols[r], everyone, dev)


class Halo:
    """The halo exchange of one vector shard: its (re, im) planes, ``n``
    blocks (or panel rows) of ``tail`` padded to ``nmax``, gathered over
    the "rows" axis with one ``all_gather`` into [pr, 2, nmax, *tail].

    In the flat gathered array, block l of row shard s has index
    ``halo_index(s, l, nmax)`` in both views the call returns, the re view
    ``flat[:span]`` and the im view ``flat[nmax:nmax + span]`` (span =
    (2*pr - 1)*nmax): the kernels read both planes with one index, and no
    copy follows the collective."""

    def __init__(self, mesh: Mesh, nmax: int, n: int, tail: tuple, dtype):
        self.mesh, self.nmax, self.n = mesh, int(nmax), int(n)
        self.tail = tuple(tail)
        self.span = (2 * mesh.pr - 1) * self.nmax
        dev = mesh.device
        self.send = torch.zeros((2, self.nmax) + self.tail, dtype=dtype,
                                device=dev)
        self.recv = torch.empty((mesh.pr, 2, self.nmax) + self.tail,
                                dtype=dtype, device=dev)

    def __call__(self, x) -> tuple:
        self.send[0, :self.n].copy_(x[0])
        self.send[1, :self.n].copy_(x[1])
        self.mesh.all_gather(self.recv, self.send, ("rows",))
        flat = self.recv.view((-1,) + self.tail)
        return (flat[:self.span],
                flat[self.nmax:self.nmax + self.span])


def halo_index(src, loc, nmax: int):
    """Index of block ``loc`` of row shard ``src`` in ``Halo``'s views."""
    return src * 2 * nmax + loc


def _row_of(rowptr) -> np.ndarray:
    rowptr = np.asarray(rowptr, np.int64)
    return np.repeat(np.arange(rowptr.shape[0] - 1, dtype=np.int64),
                     np.diff(rowptr))


def shard_pair_table(plan, part: RowPartition, row: int, col: int,
                     device) -> tuple:
    """Shard (row, col)'s pair table for K1: its own Y blocks (unpadded,
    in the partition's slot order), the X blocks of every row shard of its
    column at their ``halo_index``, and its own A blocks.  Returns
    (``PairTable`` on ``device``, the global ids of its A blocks)."""
    nmax, pr = part.nmax, part.pr
    row_of_x = _row_of(plan.rowptr_x)
    blocks = part.blocks[:, col]                   # [pr, nmax]
    n = int(np.count_nonzero(blocks[row] >= 0))
    a_ids = part.a_blocks[row][part.a_blocks[row] >= 0].astype(np.int64)
    real = part.pair_y[row, col] < nmax
    pa = part.pair_a[row, col][real].astype(np.int64)
    pxg = part.pair_xg[row, col][real].astype(np.int64)
    py = part.pair_y[row, col][real].astype(np.int64)
    px = halo_index(pxg // nmax, pxg % nmax, nmax)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(py, minlength=n), out=starts[1:])
    y_rows = row_of_x[blocks[row, :n]]
    span = (2 * pr - 1) * nmax
    x_rows = np.zeros(span, np.int64)
    x_cols = np.zeros(span, np.int64)
    for s in range(pr):
        m = blocks[s] >= 0
        idx = halo_index(s, np.flatnonzero(m), nmax)
        x_rows[idx] = row_of_x[blocks[s][m]]
        x_cols[idx] = part.colindx_local[s, col][m]

    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)

    table = PairTable(
        starts=t(starts), pairs=t(np.stack([pa, px], axis=1).reshape(-1, 2)),
        nnzb_a=int(a_ids.shape[0]), nnzb_x=span, nrows=int(plan.nrows),
        rowptr_y=np.searchsorted(y_rows, np.arange(plan.nrows + 1)),
        y_cols=part.colindx_local[row, col, :n].astype(np.int64),
        x_rows=x_rows, x_cols=x_cols)
    return table, a_ids


class ShardedAction:
    """This rank's ``y = A @ x``: the halo ``all_gather`` of X over the
    "rows" axis, then K1 over the shard's pair table against the gathered
    X (``shard_pair_table``).  Bundles the partition, the mesh and the
    shard's A blocks on its device, as the JAX ``ShardedAction`` does."""

    def __init__(self, part: RowPartition, mesh: Mesh,
                 k1: PairPlanMultiply, halo: Halo):
        self.part, self.mesh, self.k1, self.halo = part, mesh, k1, halo

    @classmethod
    def from_plan(cls, plan, part: RowPartition, mesh: Mesh, a_re,
                  a_im) -> "ShardedAction":
        """``a_re``, ``a_im``: the host planes of every A block (the same
        on every rank); the dtype of the solve is theirs."""
        mesh.require_member()
        table, a_ids = shard_pair_table(plan, part, mesh.row, mesh.col,
                                        mesh.device)
        a_re, a_im = (torch.from_numpy(np.ascontiguousarray(
            np.asarray(v)[a_ids])).to(mesh.device) for v in (a_re, a_im))
        k1 = PairPlanMultiply(table, a_re, a_im, part.ln)
        halo = Halo(mesh, part.nmax, table.nnzb_y, (part.lm, part.ln),
                    a_re.dtype)
        return cls(part, mesh, k1, halo)

    @property
    def n_local(self) -> int:
        return self.k1.nnzb_y

    def __call__(self, x) -> tuple:
        return self.k1(self.halo(x))


def sharded_primitives(mesh: Mesh, prim: TfqmrPrimitives) -> TfqmrPrimitives:
    """``prim`` with its per-column reductions summed over the "rows" axis
    (one ``all_reduce`` a call; re and im of a dotp in one tensor) and the
    mesh's ``allmax`` / ``alland``."""
    def dotp(x, y):
        z = torch.stack(prim.dotp(x, y))
        mesh.psum(z)
        return z[0], z[1]

    return dataclasses.replace(prim, dotp=dotp,
                               nrm2=lambda x: mesh.psum(prim.nrm2(x)),
                               allmax=mesh.allmax, alland=mesh.alland)


def sharded_solve_core(mesh: Mesh, act: ShardedAction, v2, v3, colindx,
                       subset, col_valid, tolerance: float,
                       max_iterations: int, *, ncmax: int, lm: int, ln: int,
                       rhs_trivial: bool = False) -> core.SolveResult:
    """This rank's loop: ``v2`` its B blocks [nb, LM, LN] (unpadded; unit
    blocks when ``rhs_trivial``), ``v3`` its slots of the shadow vector,
    ``colindx`` [n] its blocks' local compressed columns, ``subset`` [nb]
    the local slot of each B block, ``col_valid`` bool [ncmax] its column
    chunk's real columns.  Returns the ``SolveResult`` with this rank's x
    [n, LM, LN] and the replicated scalars."""
    dt = v2[0].dtype
    dev = v2[0].device
    cols = linalg.columns(colindx, ncmax)
    prim = sharded_primitives(mesh, TfqmrPrimitives(
        multiply=act, dotp=lambda x, y: linalg.dotp(x, y, cols),
        nrm2=lambda x: linalg.nrm2(x, cols),
        axpy=lambda y, x, a: linalg.axpy(y, x, a, colindx),
        xpay=lambda y, a, x: linalg.xpay(y, a, x, colindx),
        add_rhs=lambda v, b, s: linalg.add_rhs(v, b, s, subset)))
    z = torch.zeros((int(colindx.shape[0]), lm, ln), dtype=dt, device=dev)
    v5 = prim.add_rhs((z, z), v2, 1.0)
    valid = col_valid[:, None].expand(ncmax, ln)
    if rhs_trivial:
        tau0 = valid.to(torch.float64)
        inv_bn2 = tau0
    else:
        tau0 = prim.nrm2(v5)             # squared column norms of B
        inv_bn2 = torch.where(valid, core.inverse_norms(tau0), 0.0)
    return core.tfqmr_loop(prim, v2, v3, v5, tau0, inv_bn2, tolerance,
                           max_iterations, dt)


def _local(arr: np.ndarray, idx: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr)[idx], dtype=dtype)).to(device)


def sharded_solve(plan, part: RowPartition, mesh: Mesh, a_re, a_im, b_re,
                  b_im, tolerance: float = 1e-6, max_iterations: int = 999,
                  rhs_trivial: bool = False, seed: int = core.RANDOM_SEED,
                  v3=None):
    """End-to-end sharded solve on every rank of ``mesh``: the host planes
    of A [nnzbA, LM, LM] and B [nnzbB, LM, LN] (the same on every rank;
    their dtype is the solve's), and optionally the shadow vector ``v3``
    as host (re, im) [nnzbX, LM, LN] (by default
    ``core.make_shadow_vector`` of ``seed``).  Returns (x_re, x_im global
    [nnzbX, LM, LN] numpy, result dict), the same on every rank."""
    mesh.require_member()
    r, c = mesh.row, mesh.col
    lm, ln, dev = part.lm, part.ln, mesh.device
    act = ShardedAction.from_plan(plan, part, mesh, a_re, a_im)
    npdt = np.asarray(a_re).dtype
    n = act.n_local
    mine = part.blocks[r, c, :n].astype(np.int64)
    if v3 is None:
        v3 = core.make_shadow_vector(plan.nnzb_x, lm, ln, device="cpu",
                                     seed=seed)
    v3 = tuple(_local(v.cpu().numpy() if torch.is_tensor(v) else v, mine,
                      np.float32, dev) for v in v3)
    bsel = part.b_blocks[r, c][part.b_blocks[r, c] >= 0].astype(np.int64)
    subset = torch.from_numpy(part.subset_local[r, c, :bsel.shape[0]]
                              .astype(np.int64)).to(dev)
    if rhs_trivial:
        v2 = linalg.set_unit_blocks(int(bsel.shape[0]), lm, ln,
                                    act.k1.a_re.dtype, dev)
    else:
        v2 = (_local(b_re, bsel, npdt, dev), _local(b_im, bsel, npdt, dev))
    colindx = torch.from_numpy(part.colindx_local[r, c, :n]
                               .astype(np.int64)).to(dev)
    col_valid = torch.from_numpy(part.col_valid[c]).to(dev)
    res = sharded_solve_core(mesh, act, v2, v3, colindx, subset, col_valid,
                             tolerance, max_iterations, ncmax=part.ncmax,
                             lm=lm, ln=ln, rhs_trivial=rhs_trivial)
    # each rank's x, padded to nmax, to every rank
    x = res.x[0].new_zeros((2, part.nmax, lm, ln))
    x[0, :n], x[1, :n] = res.x
    xs = gather_global(x, mesh)                 # [pr, pc, 2, nmax, LM, LN]
    xg_re = unshard_blocks_array(part, xs[:, :, 0], plan.nnzb_x)
    xg_im = unshard_blocks_array(part, xs[:, :, 1], plan.nnzb_x)
    rhs_status = gather_global(res.rhs_status, mesh, ("cols",))
    info = dict(return_status=int(res.return_status),
                iterations=int(res.iterations), residuum=float(res.residuum),
                n_probes=int(res.n_probes),
                rhs_status=rhs_status.reshape(-1, ln))
    return xg_re, xg_im, info

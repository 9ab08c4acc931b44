"""Multi-process execution support: the process group, this rank's
device, and host arrays in and out of the shards.

Counterpart of ``tfqmrgpu_tpu/parallel/multihost.py``.  The sharded
solvers run one process per rank and one device per rank: every process
executes the same host code with the same host inputs (the packing is
deterministic, so every rank computes identical tables and operands), keeps
its own shard on its device and ends with the full result.  What crosses
processes goes through ``torch.distributed``: NCCL between cards, gloo
between CPU processes.

    import tfqmrgpu_tpu_torch.parallel.multihost as mh
    dev = mh.initialize()                  # under torchrun: env://
    mesh = mh.global_mesh(pr=dist.get_world_size())
    # ... ShardedRowTileSolver(plan, mesh) places its operands with
    # put_global and returns its result through gather_global.

Run on N cards of one machine with ``torchrun --nproc_per_node=N``; on the
CPU pass ``device="cpu"`` and a ``store`` (or ``init_method``), world size
and rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..plan import resolve_device


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one, else the card
    cuda:LOCAL_RANK (``torchrun`` sets LOCAL_RANK; 0 without it).  Without
    a card and without ``device`` it raises, as every entry point does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(init_method: str = None, *, store=None, world_size: int = None,
               rank: int = None, device=None) -> torch.device:
    """``init_process_group`` for this rank's device (idempotent); returns
    the device.

    The backend follows the device: NCCL for a card (which becomes the
    current device), gloo for the CPU.  The group comes from ``store`` (a
    ``torch.distributed.Store``, with ``world_size`` and ``rank``), from
    ``init_method`` (for example ``tcp://host:port`` or ``file://...``),
    under ``torchrun`` from its environment (``env://``), and otherwise it
    is a world of one."""
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    kw = dict(backend="nccl" if dev.type == "cuda" else "gloo")
    if store is None and init_method is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
        elif (world_size or 1) == 1:
            store, world_size, rank = dist.HashStore(), 1, 0
        else:
            raise ValueError(f"a world of {world_size} needs a store or an "
                             "init_method")
    if store is not None:
        kw.update(store=store, world_size=world_size, rank=rank)
    else:
        kw.update(init_method=init_method)
        if world_size is not None:
            kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(**kw)
    return dev


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(pr: int, pc: int = 1, device=None):
    """The (pr, pc) mesh over the global ranks (``sharded.make_mesh``)."""
    from .sharded import make_mesh

    return make_mesh(pr, pc, device=device)


def put_global(arr: np.ndarray, mesh, spec: tuple = ("rows", "cols")):
    """A host array whose leading axes are the mesh axes of ``spec`` (the
    stacked per-shard form of ``partition``) -> this rank's shard as a
    tensor on its device; ``spec=()`` puts the whole array."""
    mesh.require_member()
    place = {"rows": mesh.row, "cols": mesh.col}
    local = np.asarray(arr)[tuple(place[a] for a in spec)]
    return torch.from_numpy(np.ascontiguousarray(local)).to(mesh.device)


def gather_global(x: torch.Tensor, mesh, spec: tuple = ("rows", "cols")):
    """The inverse of ``put_global``: every rank's shard ``x`` (of one
    shape on every rank) -> the stacked host array, on every rank."""
    if not spec:
        return x.cpu().numpy()
    return mesh.gather(x, tuple(spec)).cpu().numpy()

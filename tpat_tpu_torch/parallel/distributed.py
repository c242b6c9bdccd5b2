"""Process-group set-up and the few collectives data parallelism needs
(``tpat_tpu/parallel/distributed.py``, the reference's
``util/misc.py:218-250``), on ``torch.distributed``.

One process drives one device.  ``init_distributed_mode`` reads the layout,
picks the rank's device and the backend, and joins the group; at one
process it does nothing.  The layout comes from, in this order:

- explicit arguments;
- the JAX package's names, ``COORDINATOR_ADDRESS`` (host:port),
  ``NUM_PROCESSES`` and ``PROCESS_ID``, so scripts written for the JAX
  drivers run unchanged;
- torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
- SLURM's ``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID`` and
  ``SLURM_NTASKS_PER_NODE`` (the address from ``MASTER_ADDR`` and
  ``MASTER_PORT``).

Without a local rank every process is taken to run on this host (local rank
= rank).  A rank's device is ``cuda:(local_rank % device_count)``, or the
CPU when the caller passes ``device="cpu"``.  The backend follows from the
layout (``choose_backend``): NCCL when each local rank owns its own card,
gloo when ranks share a card (NCCL refuses two ranks on one device) or run
on the CPU; a rank on another device, or on CUDA without a card, is
refused.  Gloo runs
``all_reduce`` and ``broadcast`` on CUDA tensors, which is all the gradient
mean needs; the host-side collectives (objects, row gathers, barriers) run
on a gloo group: the default group under gloo, a gloo subgroup made once
under NCCL.

Under a model axis (``parallel/sharding.py``) the ranks split into data and
model groups.  ``make_mesh_2d`` makes its mesh the process's active one
(``set_mesh``), and ``data_rank_world`` then gives the rank's data rank and
the data world, which the global-batch draws, the eval shards and the
eval gather read; without a mesh they are the group's rank and world.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = None  # the gloo subgroup of an NCCL run
_MESH = None  # the active (data, model) mesh, set by sharding.make_mesh_2d


@dataclasses.dataclass(frozen=True)
class Layout:
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    address: Optional[str] = None  # host:port of rank 0's store


def _first_int(env, *names) -> Optional[int]:
    for n in names:
        v = env.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def read_layout(
    rank: Optional[int] = None,
    world: Optional[int] = None,
    address: Optional[str] = None,
    local_rank: Optional[int] = None,
    local_world: Optional[int] = None,
    environ=None,
) -> Layout:
    """The process layout: each field from the explicit argument, else the
    JAX names, torchrun's, then SLURM's (see the module docstring)."""
    env = os.environ if environ is None else environ
    if world is None:
        world = _first_int(env, "NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS")
    world = 1 if world is None else world
    if rank is None:
        rank = _first_int(env, "PROCESS_ID", "RANK", "SLURM_PROCID")
    rank = 0 if rank is None else rank
    if address is None:
        address = env.get("COORDINATOR_ADDRESS") or None
    if address is None and env.get("MASTER_ADDR"):
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if local_rank is None:
        local_rank = _first_int(env, "LOCAL_RANK", "SLURM_LOCALID")
    local_rank = rank if local_rank is None else local_rank
    if local_world is None:
        per_node = env.get("SLURM_NTASKS_PER_NODE", "")
        local_world = _first_int(env, "LOCAL_WORLD_SIZE") or (
            int(per_node) if per_node.isdigit() else None)
    local_world = world if local_world is None else local_world
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} outside a local world of "
                         f"{local_world}")
    return Layout(rank, world, local_rank, local_world, address)


def choose_backend(device_type: str, local_world: int,
                   device_count: int) -> str:
    """NCCL when each of the ``local_world`` ranks of this host owns one of
    its ``device_count`` cards, gloo when ranks share a card or run on the
    CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    if device_count < 1:
        raise RuntimeError("no CUDA device for a CUDA rank")
    return "nccl" if local_world <= device_count else "gloo"


def rank_device(device, local_rank: int, device_count: int) -> torch.device:
    """The rank's device: ``cuda:(local_rank % device_count)`` for a CUDA
    ``device``, the CPU for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", local_rank % max(device_count, 1))
    return device


def init_distributed_mode(
    device="cuda",
    *,
    rank: Optional[int] = None,
    world: Optional[int] = None,
    address: Optional[str] = None,
    local_rank: Optional[int] = None,
    local_world: Optional[int] = None,
    timeout: float = 1800.0,
) -> Tuple[int, int, torch.device]:
    """Join the process group the layout describes; returns (rank, world,
    this rank's device).  At one process nothing is joined and ``device``
    comes back as given, unless ``world=1`` is passed explicitly (with an
    address): that joins a group of one, whose collectives run.  Called
    again in a process that has joined, it returns the group's rank and
    world."""
    device = torch.device(device)
    if dist.is_initialized():
        count = torch.cuda.device_count() if device.type == "cuda" else 0
        layout = read_layout(rank=dist.get_rank(), world=dist.get_world_size())
        return (dist.get_rank(), dist.get_world_size(),
                rank_device(device, layout.local_rank, count))
    layout = read_layout(rank, world, address, local_rank, local_world)
    if layout.world == 1 and world is None:
        return 0, 1, device
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    chosen = choose_backend(device.type, layout.local_world, count)
    if not layout.address:
        raise ValueError(
            f"{layout.world} processes need rank 0's address: set "
            "COORDINATOR_ADDRESS (host:port) or MASTER_ADDR and MASTER_PORT")
    device = rank_device(device, layout.local_rank, count)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        chosen, init_method=f"tcp://{layout.address}", rank=layout.rank,
        world_size=layout.world,
        timeout=datetime.timedelta(seconds=timeout))
    global _HOST_GROUP
    _HOST_GROUP = dist.new_group(backend="gloo") if chosen == "nccl" else None
    if layout.rank == 0:
        print(f"[distributed] {layout.world} processes, backend {chosen}, "
              f"rank 0 on {device}", flush=True)
    return layout.rank, layout.world, device


def leave() -> None:
    """Leave the process group (and its gloo subgroup and mesh), if
    joined."""
    global _HOST_GROUP, _MESH
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = _MESH = None


def group_rank_world() -> Tuple[int, int]:
    """(rank, world) of the joined process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def set_mesh(mesh) -> None:
    """Make ``mesh`` (a ``sharding.Mesh2D``, or None) the active mesh."""
    global _MESH
    _MESH = mesh


def data_rank_world() -> Tuple[int, int]:
    """(data rank, data world): the active mesh's, else the group's (rank,
    world)."""
    if _MESH is not None:
        return _MESH.data_rank, _MESH.dp
    return group_rank_world()


def world_size() -> int:
    """The process count: the group's, or before one is joined, the
    launcher's environment's."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return read_layout().world


def is_main_process() -> bool:
    """Rank 0 (``misc.py:202-215``)."""
    return group_rank_world()[0] == 0


def print_rank0(*args, **kwargs):
    """``print`` on rank 0 only (``misc.py`` setup_for_distributed)."""
    if is_main_process():
        print(*args, **kwargs)


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _host_group():
    return _HOST_GROUP


def _flat_(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective`` on one flat copy of the tensors per (dtype, device),
    the result copied back in place; nothing without a group."""
    if not _joined():
        return
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for group in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group`` (the
    default group when None), in place: one flat ``all_reduce`` per dtype.
    Nothing happens without a process group; a group of one still runs the
    collective."""
    def mean(flat):
        dist.all_reduce(flat, group=group)
        n = dist.get_world_size(group)
        if n > 1:
            flat /= n

    _flat_(tensors, mean)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (one flat
    broadcast per dtype); nothing without a group."""
    _flat_(tensors, lambda flat: dist.broadcast(flat, src))


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (a small picklable object)."""
    if not _joined():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=_host_group())
    return box[0]


def barrier() -> None:
    """Wait until every rank has reached this point (host-side)."""
    if _joined():
        dist.barrier(group=_host_group())


def check_equal(value: int, what: str) -> None:
    """Raise on every rank unless ``value`` is the same on all of them: a
    rank that runs more steps than another would wait in a collective the
    others never reach."""
    if not _joined():
        return
    t = torch.tensor([value, -value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(f"{what} differs across ranks: {lo} to {hi}")


def all_gather_host(arr: np.ndarray) -> List[np.ndarray]:
    """Every rank's ``arr`` (the same shape and dtype on each), in rank
    order, through the host-side group."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_host_group())
    return [o.numpy() for o in out]

"""Process groups and collectives of the port's multi-GPU layer.

The JAX package drives a ``('data', 'model')`` mesh of chips from one
process and GSPMD inserts the collectives (``parallel/mesh.py`` there), so
this module has no JAX counterpart.  The port runs one process (rank) per
GPU on ``torch.distributed``:

* ``init_distributed`` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), else from the multi-host flags (``coordinator``
  ``host:port``, ``num_hosts``, ``host_id``: a TCP rendezvous with
  ``world_size = num_hosts`` and ``rank = host_id``), else from an explicit
  ``init_method`` URL (the tests give ``file://`` stores).  With none of
  them the world has one rank and no group.
* Rank r binds ``cuda:{LOCAL_RANK % torch.cuda.device_count()}`` (``LOCAL_RANK``
  0 when unset), or the CPU when the caller asks for it.  Before the group
  starts, the ranks exchange their device's key (``device_key``: the card's
  UUID, which no two cards share on any host, where a host name may be a
  container's or a sandbox's and repeat across nodes) through the
  rendezvous store: the backend (``backend_for``) is NCCL when every rank
  has a device of its own, gloo when two ranks share one device or on the
  CPU.  Rank 0 prints the choice.  A failed NCCL start is an error: nothing
  retries on gloo.
* ``Group`` is a sub-group with its global ranks; every collective over a
  group of one rank returns at once.

Transport.  Under gloo a CUDA tensor is staged through a pinned host buffer
for every collective here (``all_reduce_``, ``all_gather``,
``broadcast_``, ``send``, ``recv_``): gloo takes no CUDA tensor for
send/recv, and one rule for all of them keeps the transport in one place.
The bytes are copied as they are, never cast, and the result is copied
back onto the card; no compute leaves it.  Under NCCL a CPU tensor goes to
the rank's device for the collective and back.

``copy_to_group`` (identity forward, all-reduce backward) and
``reduce_from_group`` (all-reduce forward, identity backward) are the two
autograd functions of Megatron tensor parallelism (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]  # None: one rank, no process group


_WORLD: Optional[World] = None


def _rank_device(device, local_rank: int) -> torch.device:
    """The CPU where asked for, else the card ``LOCAL_RANK`` maps to (an
    explicit ``cuda:i`` is taken as given)."""
    from video_depth_anything_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def device_key(dev: torch.device) -> str:
    """What tells ``dev`` apart from every other rank's device: the card's
    UUID, or ``cpu``."""
    if dev.type == "cuda":
        return f"GPU-{torch.cuda.get_device_properties(dev).uuid}"
    return "cpu"


def backend_for(keys: Sequence[str]) -> str:
    """The backend for ranks whose devices have these ``device_key``s:
    NCCL when each rank has a card of its own, else gloo."""
    if "cpu" in keys or len(set(keys)) < len(keys):
        return "gloo"
    return "nccl"


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def init_distributed(coordinator: Optional[str] = None, num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None, device=None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, timeout_s: float = 1800.0) -> World:
    """Start (once) and return this process's ``World``; see the module
    docstring for the sources, the device and the backend rule."""
    global _WORLD
    if _WORLD is not None:
        return _WORLD
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if init_method is None:
        if _torchrun_env():
            init_method, rank, world_size = "env://", -1, -1
        elif coordinator is not None or (num_hosts or 1) > 1:
            if coordinator is None or not num_hosts or host_id is None:
                raise ValueError("multi-host needs --coordinator, --num_hosts and --host_id "
                                 "(or VDA_COORDINATOR, VDA_NUM_HOSTS, VDA_HOST_ID)")
            init_method, rank, world_size = f"tcp://{coordinator}", int(host_id), int(num_hosts)
        else:
            _WORLD = World(0, 1, _rank_device(device, local_rank), None)
            return _WORLD
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    dev = _rank_device(device, local_rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(init_method, rank=rank, world_size=world_size,
                                                   timeout=timeout))
    store.set(f"vda/device/{rank}", json.dumps([device_key(dev), socket.gethostname(), str(dev)]))
    peers = [json.loads(store.get(f"vda/device/{r}")) for r in range(world_size)]
    backend = backend_for([key for key, _, _ in peers])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    _WORLD = World(rank, world_size, dev, backend)
    if rank == 0:
        why = "the CPU" if dev.type == "cpu" else (
            "every rank has a device of its own" if backend == "nccl" else "ranks share a device")
        print(f"[parallel] world size {world_size}, backend {backend} ({why}); ranks on "
              f"{sorted({f'{host} {d} {key}' for key, host, d in peers})}", flush=True)
    return _WORLD


def world() -> World:
    """The started world, or a one-rank world on the default device when
    ``init_distributed`` was not called."""
    if _WORLD is not None:
        return _WORLD
    return World(0, 1, torch.device("cpu"), None)


def rank_line(launches: dict) -> str:
    """This rank, its device, the backend, its peak device memory and its
    kernels' launch counts, on one line (the CLIs print it per rank)."""
    w = world()
    peak = torch.cuda.max_memory_allocated(w.device) / 2**20 if w.device.type == "cuda" else 0.0
    return (f"rank {w.rank}/{w.size} device {w.device} backend {w.backend} peak {peak:.1f} MiB "
            f"kernel launches: {json.dumps(launches)}")


def shutdown() -> None:
    """Destroy the process group (if any) and forget the world."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


@dataclasses.dataclass(frozen=True)
class Group:
    """A sub-group: its global ``ranks`` in order, the process group
    (``None`` for one rank) and this rank's index in it (-1 outside)."""

    ranks: tuple
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        r = world().rank
        return self.ranks.index(r) if r in self.ranks else -1


def new_group(ranks: Sequence[int]) -> Group:
    """A group over ``ranks``.  As ``dist.new_group``, every rank of the
    world must call it for every group, in one order."""
    ranks = tuple(int(r) for r in ranks)
    if world().backend is None:
        return Group(ranks)
    return Group(ranks, dist.new_group(list(ranks)))


# -- transport ------------------------------------------------------------------


def _carrier(t: torch.Tensor) -> torch.Tensor:
    """The contiguous tensor the backend takes for ``t``: a pinned host copy
    of a CUDA tensor under gloo, a device copy of a CPU tensor under NCCL,
    else ``t`` (contiguous)."""
    backend = world().backend
    if backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    if backend == "nccl" and not t.is_cuda:
        return t.to(world().device)
    return t.contiguous()


def _empty_carrier(shape, like: torch.Tensor) -> torch.Tensor:
    backend = world().backend
    if backend == "gloo" and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    if backend == "nccl" and not like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, device=world().device)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over ``group`` into ``t`` itself; returns ``t``."""
    if group.size == 1:
        return t
    x = _carrier(t)
    dist.all_reduce(x, group=group.pg)
    if x is not t:
        t.copy_(x)
    return t


def broadcast_(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """``t`` of global rank ``src`` into ``t`` on every rank of ``group``."""
    if group.size == 1:
        return t
    x = _carrier(t)
    dist.broadcast(x, src=src, group=group.pg)
    if x is not t:
        t.copy_(x)
    return t


def all_gather(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on all), in group order, on ``t``'s
    device."""
    if group.size == 1:
        return [t]
    x = _carrier(t)
    out = [_empty_carrier(x.shape, t) for _ in range(group.size)]
    dist.all_gather(out, x, group=group.pg)
    return [o.to(t.device) for o in out]


def all_gather_padded(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """``all_gather`` of pieces whose first dimension differs from rank to
    rank: each is zero-padded to the largest (as the JAX
    ``multihost.py:232-237`` pads its exchange), gathered, and cut back."""
    if group.size == 1:
        return [t]
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [int(s.item()) for s in all_gather(n, group)]
    pad = torch.zeros((max(sizes),) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    pad[: t.shape[0]] = t
    return [p[:s] for p, s in zip(all_gather(pad, group), sizes)]


def send(t: torch.Tensor, dst: int) -> None:
    """Point-to-point ``t`` to global rank ``dst`` (blocking)."""
    dist.send(_carrier(t), dst=dst)


def recv_(t: torch.Tensor, src: int) -> torch.Tensor:
    """Receive from global rank ``src`` into ``t``; returns ``t``."""
    backend = world().backend
    direct = t.is_contiguous() and not (
        (backend == "gloo" and t.is_cuda) or (backend == "nccl" and not t.is_cuda))
    x = t if direct else _empty_carrier(t.shape, t)
    dist.recv(x, src=src)
    if x is not t:
        t.copy_(x)
    return t


def barrier() -> None:
    """Wait for every rank of the world."""
    w = world()
    if w.backend is not None:
        all_reduce_(torch.zeros(1, device=w.device), Group(tuple(range(w.size))))


# -- the two autograd functions of tensor parallelism --------------------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The input of a column-parallel product."""
    if group.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The output of a row-parallel product, summed over the group.
    Without autograd the sum is made in ``x``'s own storage (the fresh
    product)."""
    if group.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce_(x, group)

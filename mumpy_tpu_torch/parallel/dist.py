"""Process group, row shards and collectives: the port's counterpart of
``mumpy_tpu/parallel/mesh.py``.

The JAX package runs one process over a 1-axis ``data`` mesh: the batch rows
sharded over the devices, the state replicated, the gradient all-reduce
inserted by XLA.  The port runs one process per card under ``torchrun``:
:func:`init_from_env` reads the ranks ``torchrun`` sets and starts the
process group (NCCL on the card, gloo on the CPU), :func:`row_shard` gives a
rank its contiguous rows of the global batch (``device_put`` on the data
axis), :func:`all_reduce_mean` averages the gradients, and
:func:`broadcast_tensors` hands rank 0's state to the others, and
:func:`gather_rows` gives every rank the others' rows where one operation
of the model reads across clips.  Serving needs
no process group: :func:`serving_devices` picks the cards one process
splits a batch over (``test.py:87``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Sequence

import torch
import torch.distributed as tdist

__all__ = ["Dist", "init_from_env", "row_shard", "all_reduce_mean", "broadcast_tensors",
           "gather_rows", "broadcast_object", "serving_devices"]

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Dist:
    """This process's place in a data-parallel run.  ``grouped``: a process
    group was started (under ``torchrun``, at any world size); without one
    every collective below is the identity."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    grouped: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if not self.grouped:
            return
        if tdist.get_backend() == "nccl":
            tdist.barrier(device_ids=[self.device.index])
        else:
            tdist.barrier()


def init_from_env(device_type: str = "cuda", backend: str = None,
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Dist:
    """The run's :class:`Dist` from ``torchrun``'s ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` (and its ``MASTER_ADDR`` / ``MASTER_PORT``).

    With no ``WORLD_SIZE``: world size 1, no process group, the device
    ``device_type`` as a one-device run names it.  Under ``torchrun`` the
    device is ``cuda:LOCAL_RANK`` (made the current device) with NCCL, or the
    CPU with gloo; ``backend`` overrides that choice (gloo ranks may share a
    card, NCCL ranks may not).  A rank that cannot start its group raises;
    a group started earlier in the process is reused."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_from_env: no CUDA device is visible")
    if "WORLD_SIZE" not in os.environ:
        return Dist(device=torch.device(device_type))
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        if not 0 <= local_rank < torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL runs on the card only; the CPU takes gloo")
    if not tdist.is_initialized():
        tdist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                                 timeout=timeout)
    return Dist(world=world, rank=rank, local_rank=local_rank, device=device, grouped=True)


def row_shard(rows: int, world: int, rank: int) -> range:
    """Rank ``rank``'s contiguous rows of a ``rows``-row global batch.  Raises
    unless ``world`` divides ``rows``, as a batch put on JAX's data axis
    must divide."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if rows % world:
        raise ValueError(f"a batch of {rows} rows does not split over {world} ranks")
    n = rows // world
    return range(rank * n, (rank + 1) * n)


def _flat_groups(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _scatter_back(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def _collective(fn, buf: torch.Tensor) -> torch.Tensor:
    """``fn(buf)`` in place; gloo reduces host memory, so a buffer on the
    card goes through a host copy there."""
    if buf.is_cuda and tdist.get_backend() == "gloo":
        host = buf.cpu()
        fn(host)
        buf.copy_(host)
    else:
        fn(buf)
    return buf


def all_reduce_mean(tensors: Sequence[torch.Tensor], dist: Dist) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce for each dtype, on one flat f32 buffer of that dtype's
    tensors (not one call per tensor), then divided by the world size."""
    if not dist.grouped:
        return
    for ts in _flat_groups(tensors).values():
        flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
        _collective(tdist.all_reduce, flat)
        flat /= dist.world
        _scatter_back(flat, ts)


def broadcast_tensors(tensors: Sequence[torch.Tensor], dist: Dist, src: int = 0) -> None:
    """Copy rank ``src``'s values into each tensor on every rank, in place:
    one broadcast for each dtype, exact (no cast)."""
    if not dist.grouped:
        return
    for ts in _flat_groups(tensors).values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        _collective(lambda b: tdist.broadcast(b, src), flat)
        _scatter_back(flat, ts)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, concatenated in rank order; the backward sums each
    rank's gradient of the whole and hands each rank its own rows."""

    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        x = x.contiguous()
        stage = x.cpu() if x.is_cuda and tdist.get_backend() == "gloo" else x
        parts = [torch.empty_like(stage) for _ in range(dist.world)]
        tdist.all_gather(parts, stage)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        dist = ctx.dist
        grad = _collective(tdist.all_reduce, grad.contiguous().clone())
        n = grad.shape[0] // dist.world
        return grad[dist.rank * n:(dist.rank + 1) * n], None


def gather_rows(x: torch.Tensor, dist: Dist) -> torch.Tensor:
    """Every rank's ``x`` (rows first), concatenated in rank order, with the
    gradient of each rank's rows summed over the ranks' losses.  The
    cross-view attention reads other ranks' query windows through it
    (``models/deformable.py``)."""
    if not dist.grouped:
        return x
    return _GatherRows.apply(x, dist)


def broadcast_object(obj, dist: Dist, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not dist.grouped:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src, device=dist.device if dist.device.type == "cuda"
                                else None)
    return box[0]


def serving_devices(batch: int, devices: Sequence) -> list:
    """The first n of ``devices``, n the largest count that divides
    ``batch`` (``test.py:87``): batch 32 on 8 cards serves on 8, batch 6 on 4
    on 3, batch 7 on 4 on 1."""
    if batch < 1 or not devices:
        raise ValueError(f"batch {batch} over {len(devices)} devices")
    n = max(d for d in range(1, len(devices) + 1) if batch % d == 0)
    return list(devices[:n])

"""Process groups, the batch split and autograd-aware collectives over
``torch.distributed`` (``tpugan_tpu/parallel/mesh.py``).

The JAX package runs data parallelism as a sharding annotation: the step is
a global-batch function, GSPMD inserts the gradient all-reduces. The port
writes them out. One process per card, launched by ``torchrun``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; without them the world is one process and no group
exists. A rank's tensors live on ``cuda:LOCAL_RANK`` unless the caller
names a device.

Every rank builds the same global batch from the same seeded iterator and
takes its contiguous rows of the batch axis (:func:`batch_sharded`); the
collectives below then make the step on the rank's rows equal the step on
the global batch:

* :func:`all_reduce` and :func:`all_gather` are autograd-aware: the
  backward of the sum is the sum of the cotangents over the ranks, the
  backward of the gather is that sum's slice of this rank (a
  reduce-scatter), so a loss whose forward pools other ranks' rows (a
  batch norm's moments) carries their terms back, as SyncBatchNorm does;
* :func:`average_gradients` averages a network's gradients in one
  flattened all-reduce.

The backend is NCCL on the card and gloo on the CPU. Ranks that share a
card get gloo (NCCL refuses two ranks on one device, :func:`shares_a_card`);
gloo's collectives on CUDA tensors are staged through host memory here,
one copy each way (:func:`_staged`). A collective that fails raises; nothing falls
back to a single process once a group is asked for.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"    # the name of the default group (the JAX mesh axis)

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """True once a process group exists."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_device(device=None) -> torch.device:
    """``device`` when given, else this rank's card, ``cuda:LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpugan_tpu_torch.parallel: no CUDA device is available; pass "
            "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank())


def shares_a_card(device=None) -> bool:
    """Whether this host's ranks share a card: more than one of them
    (``LOCAL_WORLD_SIZE``, which torchrun sets) and either a card named
    with its index (every rank gets the same arguments, so every rank runs
    on that card) or fewer cards than ranks. Every rank answers the same."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if local <= 1:
        return False
    named = device is not None and torch.device(device).index is not None
    return named or local > torch.cuda.device_count()


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device=None) -> int:
    """Join the process group and return the world size.

    With explicit arguments, or the variables ``torchrun`` sets, this
    calls ``init_process_group`` (NCCL for a CUDA device, gloo for the CPU
    or where the ranks share a card, :func:`shares_a_card`) and any
    failure raises. Without either the
    world is one process and no group is made (1 is returned). A second
    call returns the existing group's size."""
    if is_distributed():
        return dist.get_world_size()
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit and "WORLD_SIZE" not in os.environ:
        return 1
    if not explicit:
        missing = [v for v in _ENV if v not in os.environ]
        if missing:
            raise RuntimeError(f"torch.distributed environment incomplete: "
                               f"{missing} unset (launch with torchrun)")
    dev = rank_device(device)
    backend = ("nccl" if dev.type == "cuda" and not shares_a_card(device)
               else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    return dist.get_world_size()


def _group(group):
    """The default group for None or ``DATA_AXIS``, else ``group``."""
    return None if group is None or group == DATA_AXIS else group


def world_size(group=None) -> int:
    """Ranks in ``group`` (1 without a process group)."""
    return dist.get_world_size(_group(group)) if is_distributed() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    return dist.get_rank(_group(group)) if is_distributed() else 0


def require_group(what: str) -> int:
    """The world size; raises when no process group exists."""
    if not is_distributed():
        raise RuntimeError(
            f"{what} needs a torch.distributed process group: launch with "
            f"torchrun --nproc_per_node N (or set RANK, WORLD_SIZE, "
            f"MASTER_ADDR and MASTER_PORT)")
    return dist.get_world_size()


# ---------------------------------------------------------------- batch split

def rows_of(n: int, world: int, rank_: int) -> slice:
    """Rank ``rank_``'s contiguous rows of an axis of ``n``; raises unless
    ``world`` divides ``n`` (as GSPMD refuses an uneven shard)."""
    if n % world:
        raise ValueError(f"axis of {n} rows does not divide over {world} "
                         f"ranks")
    per = n // world
    return slice(rank_ * per, (rank_ + 1) * per)


def shard_rows(a, axis: int, world: int, rank_: int):
    """``a`` (numpy or torch) restricted to this rank's rows of ``axis``."""
    index = [slice(None)] * a.ndim
    index[axis] = rows_of(a.shape[axis], world, rank_)
    return a[tuple(index)]


def batch_sharded(batch: Dict, batch_axis: int = 1,
                  world: Optional[int] = None,
                  rank_: Optional[int] = None) -> Dict:
    """A frame-major batch dict ([F, B, ...] arrays) cut to this rank's rows
    of B (the host side of ``batch_sharded`` / ``device_put_batch`` /
    ``host_local_batch_to_global``). Non-array entries pass through."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    return {k: (shard_rows(v, batch_axis, world, rank_)
                if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > batch_axis
                else v)
            for k, v in batch.items()}


# ---------------------------------------------------------------- collectives

def _staged(t: torch.Tensor, group) -> bool:
    """gloo on a CUDA tensor: the collective runs on a host copy (two ranks
    sharing one card cannot use NCCL)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the ranks (no autograd); returns ``t``."""
    group = _group(group)
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_cat(t: torch.Tensor, dim: int = 1, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (no
    autograd); the shapes must agree."""
    group = _group(group)
    src = t.detach().cpu() if _staged(t, group) else t.detach().contiguous()
    if src.dtype == torch.bool:          # not every backend takes bool
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(device=t.device, dtype=t.dtype)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        r = dist.get_rank(_group(ctx.group))
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks; its gradient is the sum of the ranks'
    cotangents."""
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int = 1, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (tiled,
    as ``jax.lax.all_gather(..., tiled=True)``); its gradient is this
    rank's slice of the ranks' summed cotangents."""
    return _AllGather.apply(x, dim, group)


def average_gradients(grads: Dict[str, Optional[torch.Tensor]],
                      group=None) -> Dict[str, Optional[torch.Tensor]]:
    """The mean of every rank's gradients in one flattened all-reduce.
    Unreached parameters (None) stay None: every rank runs the same graph,
    so they are the same on every rank."""
    names = [k for k, g in grads.items() if g is not None]
    if not names:
        return dict(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    all_reduce_(flat, group)
    flat /= world_size(group)
    out = dict(grads)
    offset = 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[offset:offset + n].view_as(grads[k])
        offset += n
    return out


def mean_over_ranks(values: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of a tensor over the ranks (no autograd)."""
    return all_reduce_(values.detach().clone(), group) / world_size(group)

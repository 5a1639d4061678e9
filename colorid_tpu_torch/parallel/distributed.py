"""Multi-process initialization: the reference's rayon global thread pool
maps to a torch.distributed process group.

Usage in each process of a job (one per card, or CPU processes):

    from colorid_tpu_torch.parallel import distributed
    distributed.initialize()                  # env-driven: MASTER_ADDR,
                                              # MASTER_PORT, WORLD_SIZE, RANK
    # or explicitly:
    distributed.initialize("host0:1234", num_processes=2, process_id=i)

The backend defaults to NCCL (the cards; each rank calls
torch.cuda.set_device on its own card first); pass backend="gloo" for CPU
processes, or for several ranks on one card (NCCL takes one rank per card).

After initialize, parallel/sharded.py::make_mesh lays a mesh over every
process's devices, as jax.devices() spans every process after
jax.distributed.initialize (global_devices below), and the row layout's
merges become the collectives below. Every rank runs the same program on
the same inputs and gets the same answers (multi-controller semantics).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """torch.distributed.init_process_group over TCP at
    coordinator_address ("host:port"; None reads the environment's
    MASTER_ADDR / MASTER_PORT), with num_processes processes of which this
    is process_id (None: WORLD_SIZE / RANK from the environment)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend or "nccl", **kwargs)


def is_multi_process() -> bool:
    """Whether this process belongs to an initialized group of more than
    one process."""
    return (
        dist.is_available()
        and dist.is_initialized()
        and dist.get_world_size() > 1
    )


def global_devices(local) -> list[tuple[int, str]]:
    """The group's device list: the concatenation, over ranks, of each
    rank's ``local`` devices, each entry (owner rank, device name). A
    collective: every rank of the group calls it."""
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in local])
    return [(r, name) for r, names in enumerate(per_rank) for name in names]


# -- the collectives of the row layout's merges --------------------------------
#
# gloo does not take CUDA tensors for every collective (all_gather among
# them), so on a gloo group each helper copies its tensor to the CPU and the
# result back; on NCCL the tensors stay on the card. Either way the wire
# tensor is a copy: the caller's tensor is never reduced in place.


def _wire(t: torch.Tensor) -> torch.Tensor:
    dev = "cpu" if dist.get_backend() == "gloo" else t.device
    return t.to(dev, copy=True).contiguous()


def all_min(t: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum over ranks."""
    w = _wire(t)
    dist.all_reduce(w, op=dist.ReduceOp.MIN)
    return w.to(t.device)


def _agree(t: torch.Tensor) -> None:
    """Fails on every rank unless every rank passes a tensor of t's rank
    and size: a collective over other shapes would hang or mix data."""
    mine = torch.tensor([t.dim(), t.numel(), -t.dim(), -t.numel()], device=t.device)
    if not torch.equal(all_min(mine), mine):
        raise RuntimeError(
            f"rank {dist.get_rank()} passes a tensor of shape {list(t.shape)} to a "
            "collective and another rank passes another shape: the ranks were "
            "given different inputs"
        )


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum over ranks."""
    _agree(t)
    w = _wire(t)
    dist.all_reduce(w)
    return w.to(t.device)


def all_cat(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0, in rank order."""
    _agree(t)
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(t.device)


def all_and(t: torch.Tensor) -> torch.Tensor:
    """The bitwise AND over ranks of an integer tensor: all_cat, then a
    local AND (NCCL has no bitwise-AND reduction)."""
    parts = all_cat(t.unsqueeze(0))
    out = parts[0]
    for p in parts[1:]:
        out = out & p
    return out

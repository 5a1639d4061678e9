"""Multi-process initialization: the reference's rayon global thread pool
maps to a torch.distributed process group.

Usage in each process of a job (one per card, or CPU processes):

    from colorid_tpu_torch.parallel import distributed
    distributed.initialize()                  # env-driven: MASTER_ADDR,
                                              # MASTER_PORT, WORLD_SIZE, RANK
    # or explicitly:
    distributed.initialize("host0:1234", num_processes=2, process_id=i)

The backend defaults to NCCL (the cards); pass backend="gloo" for CPU
processes. The logical mesh of parallel/sharded.py stays within one
process: its shards sit on the devices that process names.
"""

from __future__ import annotations

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

"""Multi-process runtime initialisation.

Port of `scgaussian_tpu/parallel/hosts.py`. The JAX package calls
`jax.distributed.initialize` and then runs its SPMD programs over the
global mesh; here every process is one rank of the default
`torch.distributed` process group, with one device each: `cuda:<local
rank>` on GPUs, where NCCL carries the collectives, or the CPU, where gloo
does. Launch the same command once per rank (the train CLI's
`--multihost`), or let the train CLI start one local rank per device
(`--data_parallel D`).

Nothing falls back: a failed `init_process_group` raises, and so does a
collective that the backend cannot run on the tensors' device (gloo runs
`all_reduce` and `broadcast` on CUDA tensors, not `all_gather`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device: str | torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port on `host` that nothing listens on now."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join the default process group. A no-op for `num_processes` <= 1, as
    in JAX.

    `coordinator_address` is process 0's `host:port` (`tcp://` rendezvous);
    without it, the `env://` variables (`MASTER_ADDR`, `MASTER_PORT`,
    `WORLD_SIZE`, `RANK`) give the rendezvous, and `num_processes` and
    `process_id` default to theirs. `backend=None` picks NCCL when `device`
    is CUDA and gloo on the CPU; naming it lets processes that share one
    GPU run gloo on CUDA tensors. On CUDA the process's current device
    becomes `local_device("cuda")` before the group forms."""
    if num_processes is not None and num_processes <= 1:
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device("cuda", process_id))
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend or default_backend(device), **kwargs)


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's rank among those on its host: `LOCAL_RANK`, else the
    global rank modulo the host's GPUs (one process per GPU)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_id if process_id is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    return rank % max(torch.cuda.device_count(), 1)


def local_device(device: str | torch.device, process_id: Optional[int] = None) -> torch.device:
    """The device this rank trains on: `cuda:<local rank>` for CUDA, the
    CPU otherwise."""
    dev = torch.device(device)
    return torch.device("cuda", local_rank(process_id)) if dev.type == "cuda" else dev


def global_group():
    """The group of every process (the JAX package's `global_mesh`), or None
    when the process is alone."""
    return dist.group.WORLD if dist.is_initialized() else None


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()

"""Starting the process group (port of ``parallel/distributed.py``).

JAX runs one process per host, and ``jax.distributed.initialize`` joins
them; the port runs one process per rank (one per card, or per CPU rank in
the tests) and joins them with ``torch.distributed.init_process_group``:

  * ``init_distributed(coordinator_address, num_processes, process_id)``
    joins the group at ``tcp://coordinator_address`` when the arguments
    are given (``--multihost --coordinator_address host:port
    --num_processes W --process_id r``); otherwise from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``); otherwise as a one-rank group on the
    caller's device. ``init_method`` (any URL ``init_process_group``
    takes, e.g. ``file://`` for ranks of one host) replaces the
    coordinator's ``tcp://`` address, with the same rank and world, and
    ``timeout`` bounds the start and every collective. Idempotent, as
    JAX's is: a second call returns the group it joined. A rank on a CUDA device binds ``cuda:LOCAL_RANK``
    and talks NCCL; on the CPU it talks gloo (``mesh.backend_for``). A
    failed start raises: no rank falls back to another backend or device.
  * ``is_primary()``: rank 0 owns the log, the CSV, checkpoints and plots.
  * ``local_slot_indices(mesh)``: the partition slot of each super-step
    that this rank owns. Rank r of W trains ``batches[i + r]`` of the
    super-step whose batches start at i.

``make_global_mesh`` and ``stack_local_to_global`` have no counterpart:
JAX assembles one globally sharded array from each host's partitions,
while here each rank holds only its own partitions and nothing is
assembled.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .mesh import Mesh, backend_for, make_mesh


def _rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: on CUDA ``cuda:LOCAL_RANK`` (else the index
    the caller named, else rank modulo the host's cards); the CPU as it
    is."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        index = int(local)
    elif dev.index is not None:
        index = dev.index
    else:
        index = rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_distributed(coordinator_address: str = "", num_processes: int = 1,
                     process_id: int = 0, device="cuda",
                     init_method: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """Join (or create) the process group and return this rank's ``Mesh``
    (module docstring for where the group comes from; ``timeout`` None is
    torch's default)."""
    if num_processes > 1 and not (coordinator_address or init_method):
        raise ValueError("a multi-process run needs --coordinator_address "
                         "(host:port of rank 0)")
    if dist.is_initialized():
        return make_mesh(device=_rank_device(device, dist.get_rank()))
    env = os.environ
    kw = {} if timeout is None else dict(timeout=timeout)
    if num_processes > 1 or init_method:
        rank, world = process_id, num_processes
        kw.update(init_method=init_method or f"tcp://{coordinator_address}",
                  rank=rank, world_size=world)
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        kw.update(init_method="env://", rank=rank, world_size=world)
    else:
        rank, world = 0, 1
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
    dev = _rank_device(device, rank)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw.update(device_id=dev)
    dist.init_process_group(backend, **kw)
    return make_mesh(world, dev)


def is_primary() -> bool:
    """True on the rank that owns logging, the CSV, checkpoints and plots
    (rank 0; a process outside any group is its own primary)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_slot_indices(mesh: Mesh) -> List[int]:
    """The positions of each super-step's W partition slots that this rank
    owns: its own rank (one partition per rank per super-step)."""
    return [mesh.rank]

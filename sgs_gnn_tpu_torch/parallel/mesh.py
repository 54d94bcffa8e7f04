"""The group of ranks (port of ``parallel/mesh.py``).

JAX shards partitions over a device mesh with one axis, ``data``, and
reduces gradients with ``psum`` inside ``shard_map``. The port runs one
process per rank under ``torch.distributed``: the "mesh" is the process
group, described by ``Mesh`` (world size, this process's rank, its device
and the group's backend). ``backend_for`` is the one place that picks the
backend: NCCL for a rank on a CUDA device, gloo for a rank on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The collective backend of a rank on ``device``: 'nccl' on a CUDA
    device, 'gloo' on the CPU (the tests' ranks); nothing else."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {str(device)!r}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group."""
    world: int
    rank: int
    device: torch.device
    backend: str

    @property
    def primary(self) -> bool:
        return self.rank == 0


def device_count() -> int:
    """The number of ranks: the world size of the process group (1 when
    none is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The ``Mesh`` of the initialised process group on this rank's
    ``device``; ``n_devices``, when given, must be the world size (a rank
    cannot hold part of the group)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} ranks")
    dev = torch.device(device)
    backend = str(dist.get_backend())
    if backend != backend_for(dev):
        raise RuntimeError(f"process group backend {backend!r} does not "
                           f"serve device {dev}: {backend_for(dev)!r} does")
    return Mesh(world, dist.get_rank(), dev, backend)


def rank_seed(step_seed: int, rank: int) -> int:
    """The 64-bit generator seed of ``rank`` in the step seeded
    ``step_seed``: the counterpart of JAX's ``fold_in(key, axis_index)``."""
    return int(np.random.SeedSequence([int(step_seed), int(rank)])
               .generate_state(1, np.uint64)[0])

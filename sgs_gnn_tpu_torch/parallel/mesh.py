"""The group of ranks (port of ``parallel/mesh.py`` and of
``make_dp_tp_mesh`` in ``parallel/tensor_parallel.py``).

JAX shards partitions over a device mesh with one axis, ``data``, and
reduces gradients with ``psum`` inside ``shard_map``. The port runs one
process per rank under ``torch.distributed``: the "mesh" is the process
group, described by ``Mesh`` (world size, this process's rank, its device
and the group's backend). ``backend_for`` is the one place that picks the
backend: NCCL for a rank on a CUDA device, gloo for a rank on the CPU.

A ``Mesh`` has two axes, ``data`` (dp ranks, one partition each) and
``model`` (tp ranks sharing one partition, the hidden width split over
them; ``parallel/tensor_parallel.py``). ``make_mesh`` is the one-axis mesh
(dp = W, tp = 1); ``make_dp_tp_mesh(dp, tp)`` lays the W = dp * tp ranks
out as JAX's ``devices.reshape(dp, tp)`` does: rank r sits at
(r // tp, r % tp), its ``data_group`` holds the ranks of its column and
its ``model_group`` those of its row.
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
    """One rank's view of the process group: its size and backend, this
    rank's place on the two axes, and the ``torch.distributed`` groups of
    its column (``data_group``) and row (``model_group``); None is the
    whole group."""
    world: int
    rank: int
    device: torch.device
    backend: str
    dp: int
    tp: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

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
    rank = dist.get_rank()
    return Mesh(world, rank, dev, backend, dp=world, tp=1, data_rank=rank,
                model_rank=0)


def make_dp_tp_mesh(dp: int, tp: int, device=None) -> Mesh:
    """The ("data", "model") ``Mesh`` of the initialised group of dp * tp
    ranks on this rank's ``device`` (None: the group's own, the current
    card under NCCL, else the CPU), with its two subgroups (module
    docstring). Every rank creates every subgroup, in one order:
    ``dist.new_group`` is collective over the whole group."""
    if not dist.is_initialized():
        raise RuntimeError("make_dp_tp_mesh: no process group; call "
                           "parallel.init_distributed first")
    world = dist.get_world_size()
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"make_dp_tp_mesh: dp={dp} x tp={tp} is not the "
                         f"world size {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else "cpu")
    base = make_mesh(world, device)
    d, m = divmod(base.rank, tp)
    data_groups = [dist.new_group([i * tp + j for i in range(dp)])
                   for j in range(tp)]
    model_groups = [dist.new_group([i * tp + j for j in range(tp)])
                    for i in range(dp)]
    return dataclasses.replace(base, dp=dp, tp=tp, data_rank=d,
                               model_rank=m, data_group=data_groups[m],
                               model_group=model_groups[d])


def rank_seed(step_seed: int, rank: int) -> int:
    """The 64-bit generator seed of ``rank`` in the step seeded
    ``step_seed``: the counterpart of JAX's ``fold_in(key, axis_index)``."""
    return int(np.random.SeedSequence([int(step_seed), int(rank)])
               .generate_state(1, np.uint64)[0])

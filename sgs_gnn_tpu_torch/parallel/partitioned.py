"""Partition data-parallel training (port of ``parallel/partitioned.py``).

The reference trains its METIS cluster batches one after another with an
optimizer step per batch. Here W ranks each take one partition of a
super-step: every rank runs the learned-mode loss on its own partition
(the numerics of one sequential batch), the gradients are averaged over
the ranks, and one synchronised dual-Adam update follows, the same on
every rank. The conditional gate stays per partition: each rank zeroes
its own edge-scorer gradients (``train/optim.edge_filter``) when its gate
failed, before the sum, and the edge group steps when any rank's gate
passed (a MAX all-reduce).

Each rank draws from a generator reseeded from the step's seed and its
rank (``mesh.rank_seed``), the counterpart of JAX's ``fold_in(key,
axis_index)``. The gradients, the loss and both F1s travel in one
bucketed all-reduce (SUM, then divided by W), the gate in a second (MAX).
A rank's partitions are its own; nothing is stacked or gathered.

On a two-axis mesh (``mesh.make_dp_tp_mesh``, JAX's data x model
parallelism, tensor_parallel.py:26-28) the partitions are spread over the
``data`` axis: the reductions run over ``mesh.data_group`` (the dp ranks
whose shards have the same shapes), the means divide by dp, and the draws
are seeded by ``mesh.data_rank``, so the tp ranks of one partition draw
the same samples. With tp = 1 these are the whole group and the rank.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..core.config import Config
from ..core.graph import Graph
from ..eval.evaluate import KEYS, make_eval_step
from ..sparsify.sampling import temperature_at
from ..train.optim import DualOptimizer, edge_filter
from ..train.pipelines import (StepMetrics, make_baseline_loss,
                               make_learned_loss, param_grads)
from .mesh import Mesh, rank_seed


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh
                    ) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, by one SUM all-reduce of
    their f32 concatenation (one bucket, not one collective per tensor),
    divided by dp (the ranks of ``mesh.data_group``); each result in its
    tensor's shape, f32."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat = flat / mesh.dp
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def all_reduce_any(flag: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """True on every rank when ``flag`` (a bool scalar) holds on any rank
    of ``mesh.data_group``: a MAX all-reduce."""
    v = flag.to(torch.int32).reshape(1).clone()
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=mesh.data_group)
    return v[0] > 0


def make_parallel_train_step(cfg: Config, model, opt: DualOptimizer, q: int,
                             max_epoch: int, mesh: Mesh):
    """``step(g, epoch, step_seed, generator) -> StepMetrics``: one
    super-step on this rank's partition ``g``, then the synchronised
    update of ``model``'s parameters in place. The metrics are the ranks'
    means (the loss and F1s) and the any-rank gate, the same on every rank.
    Baseline modes: ``make_baseline_loss`` and ``step_all``."""
    edge = [edge_filter(n) for n in opt.names]
    params = opt.params

    def temperature(epoch):
        return temperature_at(epoch, max_epoch, cfg.t_init, cfg.t_min)

    if cfg.mode != "learned":
        loss_fn = make_baseline_loss(cfg, model, q)

        def baseline_step(g: Graph, epoch: int, step_seed: int,
                          generator: torch.Generator) -> StepMetrics:
            generator.manual_seed(rank_seed(step_seed, mesh.data_rank))
            loss = loss_fn(g, generator)
            *grads, loss = all_reduce_mean(
                param_grads(loss, params) + [loss], mesh)
            opt.step_all(grads)
            zero = torch.zeros((), device=g.x.device)
            return StepMetrics(loss, temperature(epoch), zero, zero, zero)
        return baseline_step

    loss_fn = make_learned_loss(cfg, model, q)

    def step(g: Graph, epoch: int, step_seed: int,
             generator: torch.Generator) -> StepMetrics:
        generator.manual_seed(rank_seed(step_seed, mesh.data_rank))
        total, (gate, lf1, rf1) = loss_fn(g, generator)
        gate_f = gate.float()
        grads = [gr * gate_f if e else gr
                 for gr, e in zip(param_grads(total, params), edge)]
        *grads, loss, lf1, rf1 = all_reduce_mean(grads + [total, lf1, rf1],
                                                 mesh)
        any_gate = all_reduce_any(gate, mesh)
        opt.step_learned(grads, any_gate)
        return StepMetrics(loss, temperature(epoch), any_gate.float(), lf1,
                           rf1)

    return step


def make_parallel_eval_step(cfg: Config, model, q: int, mesh: Mesh):
    """``eval_step(g, stream_seed, generator) -> {KEYS: device scalar}``:
    ``make_eval_step`` on this rank's partition, its draws from the
    stream's seed and the rank; each weighted F1 and count summed over the
    ranks in one all-reduce."""
    inner = make_eval_step(cfg, model, q)

    def eval_step(g: Graph, stream_seed: int, generator: torch.Generator
                  ) -> Dict[str, torch.Tensor]:
        generator.manual_seed(rank_seed(stream_seed, mesh.data_rank))
        res = inner(g, generator)
        vals = torch.stack([res[k].float() for k in KEYS])
        dist.all_reduce(vals, group=mesh.data_group)
        return dict(zip(KEYS, vals.unbind()))

    return eval_step

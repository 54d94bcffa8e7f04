"""Halo-exchange training: full-graph semantics over partitioned storage
(port of ``parallel/halo_train.py``).

The reference's cluster batching drops inter-cluster edges
(``parallel/partitioned.py`` keeps that for parity). The halo route is
the superset: each rank owns

  * a node shard (features, labels, masks) and
  * ALL edges arriving at its nodes, inter-partition ones included.

The exchange (v2) follows the JAX ring: host tables give, for each pair of
ranks, the rows one must ship to the other (the boundary set of the
receiver's inbound edges), and at ring round r rank p ships its set to
rank (p + r) % D, padded to the round's largest set. Received rows go
after the local shard, in round order, and every sender id is a position
in that extended table, so no global gather is formed. Here the D - 1
rounds are one ``all_to_all_single`` with per-destination splits (a round
that is empty for every pair has split 0 and moves nothing; with no
boundary at all nothing is called), and its backward is the reverse
all-to-all (``_AllToAll``). The v1 all-gather stays as the reference in
``parallel/halo.py``.

The model is the port's own modules: every layer and scorer takes the
``exchange`` / ``edge_mask`` hooks (``models/layers.py``), so a layer
projects its local rows, exchanges the projections and aggregates its
inbound edges locally. The score head runs the fused kernels (K3, K5) on
``exchange(h)``, whose first rows are the local ones. The train step runs
every pipeline with per-rank sampling of ``q_loc`` of the rank's own
inbound edges (the reference driver's per-partition q); the scorer's
encoder propagates on the whole halo graph. Losses are global means
assembled from per-rank sums by an all-reduce with a gradient
(``_AllReduceSum``: its backward is again a SUM all-reduce), so, as in
JAX, each rank's gradients carry a factor D, which the mean over ranks
removes; the conditional gate compares the global train F1s of the
learned and the random forwards. One replicated dual-Adam update follows.

Each rank's draws come from a generator reseeded from the step's seed and
its rank (``mesh.rank_seed``, JAX's ``fold_in``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import Config
from ..core.device import resolve_device
from ..eval.evaluate import KEYS, SPLITS
from ..ops.edge_gather import gather_rows
from ..sparsify.sampling import (random_edges, sample_edges,
                                 sample_prior_edges, temperature_at)
from ..train.optim import DualOptimizer
from ..train.pipelines import StepMetrics, param_grads
from .mesh import Mesh, rank_seed
from .partitioned import all_reduce_mean


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with the reverse all-to-all as its backward:
    what a rank sent, it receives the cotangent of."""

    @staticmethod
    def forward(ctx, send, recv_splits, send_splits):
        ctx.splits = (recv_splits, send_splits)
        recv = send.new_empty((sum(recv_splits),) + send.shape[1:])
        dist.all_to_all_single(recv, send.contiguous(), recv_splits,
                               send_splits)
        return recv

    @staticmethod
    def backward(ctx, g):
        recv_splits, send_splits = ctx.splits
        back = g.new_empty((sum(send_splits),) + g.shape[1:])
        dist.all_to_all_single(back, g.contiguous(), send_splits,
                               recv_splits)
        return back, None, None


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce whose backward is a SUM all-reduce of the
    cotangents (``jax.lax.psum``'s transpose)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


class Exchange:
    """``exchange(v) -> v_ext`` for one rank (JAX ``make_exchange``):
    ``send_idx`` (sum H_r,) holds the rank's local rows to ship, round by
    round, each round padded to H_r; ``v`` is (N_loc, F) or (N_loc,); the
    result is ``v`` followed by the rows received in each non-empty ring
    round, the positions ``senders_ext`` holds.

    ``send_splits[d]`` / ``recv_splits[d]`` are the rows sent to / received
    from rank d in the one all-to-all (round (d - rank) % D and (rank - d)
    % D respectively; 0 for this rank and for empty rounds)."""

    def __init__(self, send_idx: np.ndarray, round_sizes: Tuple[int, ...],
                 world: int, rank: int, device):
        if len(round_sizes) != world - 1:
            raise ValueError(f"{len(round_sizes)} ring rounds for "
                             f"{world} ranks")
        offs = np.concatenate([[0], np.cumsum(round_sizes)]).astype(int)
        self.send_splits = [0] * world
        self.recv_splits = [0] * world
        for r in range(1, world):
            self.send_splits[(rank + r) % world] = int(round_sizes[r - 1])
            self.recv_splits[(rank - r) % world] = int(round_sizes[r - 1])
        # rows for each destination, in rank order (the all-to-all's layout)
        by_dst = [send_idx[offs[r - 1]:offs[r]]
                  for r in ((d - rank) % world for d in range(world)
                            if d != rank)]
        self.send_rows = torch.as_tensor(
            np.concatenate(by_dst or [np.zeros(0, np.int32)])
            .astype(np.int32), device=device)
        # the received blocks arrive in source order; the extended table
        # takes them in round order
        src_off = np.concatenate([[0], np.cumsum(self.recv_splits)])
        self.recv_slices = []
        for r in range(1, world):
            h = int(round_sizes[r - 1])
            if h:
                src = (rank - r) % world
                self.recv_slices.append((int(src_off[src]), h))
        self.rows = int(sum(round_sizes))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if self.rows == 0:
            return v
        send = gather_rows(v, self.send_rows)
        recv = _AllToAll.apply(send, self.recv_splits, self.send_splits)
        return torch.cat([v] + [recv[o:o + h] for o, h in self.recv_slices])


@dataclasses.dataclass(frozen=True)
class HaloBatch:
    """One rank's halo shard, on its device.

    ``senders_ext`` are positions in the extended table ``[local shard
    (N_loc rows) | round 1 (H_1) | ... | round D-1]``; ``receivers_loc``
    local rows of this shard. Padding edge slots have ``edge_mask`` False,
    point at row 0 and have zero prior; padding node slots have every mask
    False and zero features. Every rank's shard has the same shapes."""
    x: torch.Tensor              # (N_loc, F) float32
    senders_ext: torch.Tensor    # (E_loc,) int32
    receivers_loc: torch.Tensor  # (E_loc,) int32
    edge_mask: torch.Tensor      # (E_loc,) bool
    y: torch.Tensor              # (N_loc,) int32
    train_mask: torch.Tensor     # (N_loc,) bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    prob: torch.Tensor           # (E_loc,) f32 sampling prior
    node_mask: torch.Tensor      # (N_loc,) bool
    send_idx: np.ndarray         # (sum_r H_r,) local rows to ship
    exchange: Exchange
    num_nodes: int = 0           # global N
    num_classes: int = 0
    q_loc: int = 0               # per-rank sampled-edge budget
    round_sizes: Tuple[int, ...] = ()   # H_r per ring round
    ext_rows: int = 0            # rows one exchange moves, all ranks (v2)
    gather_rows: int = 0         # rows an all-gather would move (v1)
    n_devices: int = 1
    rank: int = 0
    valid_edges: int = 0         # inbound edges of all ranks (= E)


def build_halo_batch(x, edge_index, y, train_mask, val_mask, test_mask,
                     prob, num_parts: int, num_classes: int,
                     sample_perc: float = 0.2,
                     part: Optional[np.ndarray] = None, rank: int = 0,
                     device="cuda") -> HaloBatch:
    """Rank ``rank``'s shard of the halo tables, built on the host (every
    rank builds the same tables and keeps its row). ``part`` assigns each
    node to a rank; by default the native partitioner's. Every rank gets
    all inbound edges of its nodes, unlike ``induced_subgraphs``. The
    per-pair boundary sets (the sorted remote senders each rank's edges
    reference) make the ring schedule; ``q_loc`` is ``sample_perc`` of the
    smallest rank's edge count."""
    from ..data.partition import partition_nodes, resolve_partitioner

    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    edge_index = np.asarray(edge_index, np.int64)
    n = x.shape[0]
    if part is None:
        part = partition_nodes(edge_index, n, num_parts,
                               method=resolve_partitioner("native"))
    part = np.asarray(part)
    s_all, r_all = edge_index
    d = num_parts
    nodes = [np.where(part == p)[0] for p in range(d)]
    n_loc = max(max(len(v) for v in nodes), 1)
    local_of = -np.ones(n, np.int64)
    for p in range(d):
        local_of[nodes[p]] = np.arange(len(nodes[p]))
    edge_sets = [np.where(part[r_all] == p)[0] for p in range(d)]
    e_loc = max(max(len(v) for v in edge_sets), 1)

    # pair_nodes[p][dv]: the global ids owned by p that dv's inbound edges
    # reference, sorted (position = slot in dv's receive block)
    pair_nodes = [[np.zeros(0, np.int64)] * d for _ in range(d)]
    for dv in range(d):
        sg = s_all[edge_sets[dv]]
        owners = part[sg]
        for p in range(d):
            if p != dv:
                pair_nodes[p][dv] = np.unique(sg[owners == p])
    round_sizes = tuple(
        int(max(len(pair_nodes[p][(p + r) % d]) for p in range(d)))
        for r in range(1, d))
    h_sum = int(sum(round_sizes))
    send_idx = np.zeros(h_sum, np.int32)
    off = 0
    for r in range(1, d):
        u = pair_nodes[rank][(rank + r) % d]
        send_idx[off:off + len(u)] = local_of[u]
        off += round_sizes[r - 1]
    round_off = n_loc + np.concatenate([[0], np.cumsum(round_sizes)])

    eidx = edge_sets[rank]
    sg = s_all[eidx]
    src = part[sg]
    pos = np.where(src == rank, local_of[sg], 0).astype(np.int64)
    for p in range(d):
        m = src == p
        if p == rank or not m.any():
            continue
        r = (rank - p) % d
        pos[m] = round_off[r - 1] + np.searchsorted(pair_nodes[p][rank],
                                                    sg[m])
    prob = (np.full(len(s_all), 1.0 / max(len(s_all), 1), np.float32)
            if prob is None else np.asarray(prob, np.float32))

    def padded(values, size, dtype, fill=0):
        out = np.full((size,) + np.shape(values)[1:], fill, dtype)
        out[:len(values)] = values
        return torch.as_tensor(out, device=dev)

    mine = nodes[rank]
    min_valid = min(max(len(v), 1) for v in edge_sets)
    return HaloBatch(
        x=padded(x[mine], n_loc, np.float32),
        senders_ext=padded(pos, e_loc, np.int32),
        receivers_loc=padded(local_of[r_all[eidx]], e_loc, np.int32),
        edge_mask=padded(np.ones(len(eidx), bool), e_loc, bool),
        y=padded(np.asarray(y)[mine], n_loc, np.int32),
        train_mask=padded(np.asarray(train_mask)[mine], n_loc, bool),
        val_mask=padded(np.asarray(val_mask)[mine], n_loc, bool),
        test_mask=padded(np.asarray(test_mask)[mine], n_loc, bool),
        prob=padded(prob[eidx], e_loc, np.float32),
        node_mask=padded(np.ones(len(mine), bool), n_loc, bool),
        send_idx=send_idx,
        exchange=Exchange(send_idx, round_sizes, d, rank, dev),
        num_nodes=n, num_classes=int(num_classes),
        q_loc=max(1, int(sample_perc * min_valid)), round_sizes=round_sizes,
        ext_rows=d * h_sum, gather_rows=d * d * n_loc, n_devices=d,
        rank=rank, valid_edges=int(len(s_all)))


# ---------------------------------------------------------------- the model


def halo_gnn_forward(model, hb: HaloBatch, senders, receivers, weights,
                     edge_mask, deterministic: bool = True, generator=None):
    """The backbone on this rank's shard, exchanging per layer."""
    return model(hb.x, senders, receivers, weights, deterministic,
                 generator, hb.exchange, edge_mask)


def halo_scorer_encode(model, hb: HaloBatch, deterministic: bool = True,
                       generator=None):
    """The scorer's encoder on the whole halo graph of this rank."""
    return model.encode_scorer(hb.x, hb.senders_ext, hb.receivers_loc,
                               deterministic, generator, hb.exchange,
                               hb.edge_mask)


def halo_score_head(model, hb: HaloBatch, h, senders, receivers,
                    deterministic: bool = True, generator=None):
    """The score head over this rank's (senders_ext, receivers_loc) edges;
    boundary senders' embeddings arrive by the exchange of h."""
    return model.score_from_embeddings(h, senders, receivers, deterministic,
                                       generator=generator,
                                       exchange=hb.exchange)


# ------------------------------------------------ global losses and metrics


def global_masked_ce(logits, labels, mask):
    """Mean CE over the masked nodes of every rank."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    m = mask.float()
    s, c = global_sum(torch.stack([torch.sum(nll * m), torch.sum(m)]))
    return s / torch.clamp(c, min=1.0)


def global_micro_f1(logits, labels, mask):
    """Micro-F1 (accuracy) over the masked nodes of every rank."""
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    m = mask.float()
    sums = torch.stack([torch.sum(hit * m), torch.sum(m)]).detach()
    dist.all_reduce(sums)
    return sums[0] / torch.clamp(sums[1], min=1.0)


def global_assortative_bce(edge_probs, hu_train, hv_train, same):
    """reg1 over every rank's sampled edges, with the global
    more-than-one-positive gate."""
    labels = same.to(edge_probs.dtype)
    p = torch.clamp(edge_probs, 1e-38, 1.0 - 1e-7)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    valid = (hu_train & hv_train).to(edge_probs.dtype)
    s, c, n_pos = global_sum(torch.stack([
        torch.sum(bce * valid), torch.sum(valid), torch.sum(labels * valid)]))
    return torch.where(n_pos > 1.0, s / torch.clamp(c, min=1.0), 0.0)


def global_consistency(edge_probs, emb_u, emb_v, n_total: int):
    """reg2 over every rank's sampled edges: the squared gap between each
    edge's probability and its endpoints' cosine, summed, over
    ``n_total``."""
    num = torch.sum(emb_u * emb_v, dim=-1)

    def safe_norm(v):
        return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-16))

    cos = num / (torch.clamp(safe_norm(emb_u), min=1e-8)
                 * torch.clamp(safe_norm(emb_v), min=1e-8))
    return global_sum(torch.sum((edge_probs - cos) ** 2)) / n_total


# ------------------------------------------------------ train / eval steps


def _check_group(hb: HaloBatch, mesh: Mesh):
    if (hb.n_devices, hb.rank) != (mesh.world, mesh.rank):
        raise ValueError(f"halo batch of rank {hb.rank} of {hb.n_devices} "
                         f"on rank {mesh.rank} of {mesh.world}")


def make_halo_train_step(cfg: Config, model, opt: DualOptimizer,
                         max_epoch: int, mesh: Mesh):
    """``step(hb, epoch, step_seed, generator) -> StepMetrics``: one
    synchronised update of ``model``'s parameters in place from this
    rank's shard ``hb``. Learned mode runs ``cfg.pipeline`` (hybrid with
    and without rescoring, straight_through, two_pass) with per-rank
    sampling of ``hb.q_loc`` edges; full / random / edge run the backbone
    on the whole halo graph / a uniform / a prior draw of ``q_loc`` edges
    and step the 'all' group. The metrics are global, the same on every
    rank."""
    mode, pipeline = cfg.mode, cfg.pipeline
    params = opt.params

    def learned_loss(hb: HaloBatch, gen):
        s_ext, r_loc, emask = hb.senders_ext, hb.receivers_loc, hb.edge_mask
        y, tmask, q_loc = hb.y, hb.train_mask, hb.q_loc
        ones = torch.ones(q_loc, dtype=torch.bool, device=y.device)

        def sample(probs, straight_through=False):
            idx, w = sample_edges(gen, probs, hb.prob, q_loc,
                                  cfg.degree_bias_coef, edge_mask=emask)
            return idx, w if straight_through else None

        def head(h, s, r):
            return halo_score_head(model, hb, h, s, r, False, gen)

        if pipeline == "two_pass":
            # the sampling pass is detached; the grad pass re-propagates
            # the encoder on the sampled subgraph (training_two_pass.py)
            with torch.no_grad():
                h = halo_scorer_encode(model, hb, False, gen)
                idx, _ = sample(head(h, s_ext, r_loc))
            s_s, s_r = s_ext[idx], r_loc[idx]
            h2 = model.encode_scorer(hb.x, s_s, s_r, False, gen,
                                     hb.exchange, ones)
            weights = head(h2, s_s, s_r)
        else:
            h = halo_scorer_encode(model, hb, False, gen)
            if pipeline == "hybrid" and cfg.hybrid_rescore:
                with torch.no_grad():
                    idx, _ = sample(head(h.detach(), s_ext, r_loc))
                s_s, s_r = s_ext[idx], r_loc[idx]
                weights = head(h, s_s, s_r)
            elif pipeline == "hybrid":
                probs_full = head(h, s_ext, r_loc)
                idx, _ = sample(probs_full.detach())
                s_s, s_r = s_ext[idx], r_loc[idx]
                weights = probs_full[idx]
            elif pipeline == "straight_through":
                idx, weights = sample(head(h, s_ext, r_loc), True)
                s_s, s_r = s_ext[idx], r_loc[idx]
            else:
                raise ValueError(pipeline)

        out = halo_gnn_forward(model, hb, s_s, s_r, weights, ones, False,
                               gen)
        loss = global_masked_ce(out, y, tmask)
        if cfg.reg1:
            # boundary senders' labels and train flags ride one exchange
            lab = hb.exchange(y * 2 + tmask.to(torch.int32))
            ls, lr = lab[s_s], lab[s_r]
            loss = loss + cfg.regularizer1_coef * global_assortative_bce(
                weights, (ls % 2) > 0, (lr % 2) > 0, (ls // 2) == (lr // 2))
        if cfg.reg2:
            out_ext = hb.exchange(out)
            loss = loss + cfg.consist_reg_coef * global_consistency(
                weights, gather_rows(out_ext, s_s), gather_rows(out, s_r),
                q_loc * hb.n_devices)
        if not cfg.conditional:
            zero = torch.zeros((), device=y.device)
            return loss, (torch.ones((), dtype=torch.bool, device=y.device),
                          zero, zero)
        r_idx = sample_prior_edges(gen, hb.prob, q_loc, emask)
        rand_out = halo_gnn_forward(model, hb, s_ext[r_idx], r_loc[r_idx],
                                    None, ones, False, gen)
        lf1 = global_micro_f1(out, y, tmask)
        rf1 = global_micro_f1(rand_out, y, tmask)
        gate = (lf1 > rf1).detach()
        loss_rand = global_masked_ce(rand_out, y, tmask)
        return torch.where(gate, loss, loss_rand), (gate, lf1, rf1)

    def baseline_loss(hb: HaloBatch, gen):
        s_ext, r_loc, emask = hb.senders_ext, hb.receivers_loc, hb.edge_mask
        if mode == "full":
            s_s, s_r, msk = s_ext, r_loc, emask
        else:
            if mode == "random":
                idx = random_edges(gen, emask.shape[0], hb.q_loc,
                                   edge_mask=emask)
            elif mode == "edge":
                idx = sample_prior_edges(gen, hb.prob, hb.q_loc, emask)
            else:
                raise ValueError(mode)
            s_s, s_r = s_ext[idx], r_loc[idx]
            msk = torch.ones(hb.q_loc, dtype=torch.bool, device=emask.device)
        out = halo_gnn_forward(model, hb, s_s, s_r, None, msk, False, gen)
        zero = torch.zeros((), device=emask.device)
        return global_masked_ce(out, hb.y, hb.train_mask), (
            torch.zeros((), dtype=torch.bool, device=emask.device), zero,
            zero)

    loss_fn = learned_loss if mode == "learned" else baseline_loss

    def step(hb: HaloBatch, epoch: int, step_seed: int,
             generator: torch.Generator) -> StepMetrics:
        _check_group(hb, mesh)
        generator.manual_seed(rank_seed(step_seed, mesh.rank))
        total, (gate, lf1, rf1) = loss_fn(hb, generator)
        # the loss is the global one on every rank, so each rank's
        # gradients carry a factor D (module docstring): the mean removes it
        grads = all_reduce_mean(param_grads(total, params), mesh)
        if mode == "learned":
            opt.step_learned(grads, gate)
        else:
            opt.step_all(grads)
        return StepMetrics(total.detach(),
                           temperature_at(epoch, max_epoch, cfg.t_init,
                                          cfg.t_min), gate.float(), lf1, rf1)

    return step


@torch.no_grad()
def halo_full_forward(model, hb: HaloBatch, mesh: Mesh) -> torch.Tensor:
    """The deterministic full-graph forward on this rank's shard: (N_loc,
    C) logits."""
    _check_group(hb, mesh)
    return halo_gnn_forward(model, hb, hb.senders_ext, hb.receivers_loc,
                            None, hb.edge_mask)


def make_halo_eval_step(cfg: Config, model, mesh: Mesh):
    """``eval_step(hb, stream_seed, generator) -> {KEYS: device scalar}``:
    the ensemble eval on the halo graph (``eval/evaluate.make_eval_step``'s
    contract): the deterministic scorer once, ``num_samples_eval`` draws
    of ``q_loc`` edges per rank, logits averaged; every weighted F1 and
    count summed over the ranks in one all-reduce."""
    mode = cfg.mode

    @torch.no_grad()
    def eval_step(hb: HaloBatch, stream_seed: int,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        _check_group(hb, mesh)
        generator.manual_seed(rank_seed(stream_seed, mesh.rank))
        s_ext, r_loc, emask = hb.senders_ext, hb.receivers_loc, hb.edge_mask
        if mode == "full":
            logits = halo_gnn_forward(model, hb, s_ext, r_loc, None, emask)
        else:
            if mode == "learned":
                h = halo_scorer_encode(model, hb)
                probs = halo_score_head(model, hb, h, s_ext, r_loc)
            ones = torch.ones(hb.q_loc, dtype=torch.bool,
                              device=emask.device)
            total = None
            for _ in range(cfg.num_samples_eval):
                w = None
                if mode == "learned":
                    idx, w = sample_edges(generator, probs, hb.prob,
                                          hb.q_loc, cfg.degree_bias_coef,
                                          istest=True, edge_mask=emask)
                elif mode == "random":
                    idx = random_edges(generator, emask.shape[0], hb.q_loc,
                                       edge_mask=emask)
                else:
                    idx = sample_prior_edges(generator, hb.prob, hb.q_loc,
                                             emask)
                out = halo_gnn_forward(model, hb, s_ext[idx], r_loc[idx], w,
                                       ones)
                total = out if total is None else total + out
            logits = total / cfg.num_samples_eval
        hit = (torch.argmax(logits, -1) == hb.y.long()).float()
        sums = []
        for split in SPLITS:
            m = getattr(hb, f"{split}_mask").float()
            sums += [torch.sum(hit * m), torch.sum(m)]
        vals = torch.stack(sums)
        dist.all_reduce(vals)
        return dict(zip(KEYS, vals.unbind()))

    return eval_step

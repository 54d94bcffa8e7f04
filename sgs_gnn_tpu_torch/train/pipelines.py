"""Training step of the learned ``hybrid`` pipeline with ``hybrid_rescore``
(port of ``train/pipelines.py``: ``make_learned_loss``'s hybrid_rescore
branch, its no-tile-index variant and the shared tail, and
``make_train_step`` in learned mode).

One step, on one cluster partition:

  1. a degree-prior random q-subgraph (``sample_prior_edges``): the
     scorer's propagation graph (``sparse_edge_mlp``) and the conditional
     gate's comparison forward;
  2. the scorer's encoder on it -> h (N, nhid), with gradients;
  3. a detached pass that scores every edge from h: with a tile index, K6
     over every tile slot in tile order, sampled in tile space; without
     one, K3 over the edge list;
  4. the q winners, sorted (sender-major in tile space, receiver-sorted
     edge ids otherwise, unless ``sorted_head='off'``), with endpoints,
     validity and reg1 flags from one packed aux-row gather;
  5. the grad-enabled head on the q sampled edges (K3 forward, K5
     backward);
  6. the tail: the backbone on the sampled edges weighted by the head's
     probabilities, masked CE, reg1 (packed flags), reg2, and the
     conditional gate (a second backbone forward on the random subgraph,
     micro-F1 of both, ``torch.where`` on the detached comparison);
  7. the dual-Adam update (``train/optim.py``), the edge group gated.

In PyTorch idiom the module holds the parameters, the optimizer updates
them in place, and the step takes ``(graph, epoch, generator)``: every
random draw of the step comes from that ``torch.Generator``, on the
graph's device. Nothing in the step reads a value back to the host. The
JAX package's TPU gates on this path (``dense_subgraph``, the h width
limit of the tile kernel, fused-head VMEM budgets) are not copied. Other
pipelines and modes raise ``NotImplementedError`` (ROADMAP.md, slice 5).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import Config
from ..core.graph import Graph
from ..models.scorers import draw_seed
from ..sparsify.sampling import (sample_edges, sample_prior_edges,
                                 temperature_at)
from .losses import (assortative_bce_flags, consistency_loss,
                     masked_cross_entropy, micro_f1)
from .optim import DualOptimizer


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    temperature: float
    conditional_update: torch.Tensor  # 1.0 if the edge scorer was updated
    learned_f1: torch.Tensor
    random_f1: torch.Tensor


def _not_ported(what: str):
    return NotImplementedError(
        f"{what}: the port carries the learned hybrid pipeline with "
        "hybrid_rescore so far; the other pipelines and modes come with a "
        "later slice (ROADMAP.md)")


def _apply_gnn(model, x, s, r, w, generator):
    return model(x, s, r, w, deterministic=False, generator=generator)


def _aux_columns(aux):
    """(senders, receivers, valid, flags) of packed aux rows, the id columns
    contiguous as the kernels take them."""
    flags = aux[:, 2].contiguous()
    return (aux[:, 0].contiguous(), aux[:, 1].contiguous(), (flags & 4) > 0,
            flags)


def make_learned_loss(cfg: Config, model, q: int):
    """``loss_fn(g, generator) -> (total, (gate, lf1, rf1))`` of one batch;
    all three aux values are device tensors."""
    if cfg.pipeline != "hybrid" or not cfg.hybrid_rescore:
        raise _not_ported(f"pipeline={cfg.pipeline!r} hybrid_rescore="
                          f"{cfg.hybrid_rescore}")

    def loss_fn(g: Graph, generator: torch.Generator):
        dev = g.x.device
        use_rand = cfg.conditional or cfg.sparse_edge_mlp
        if use_rand:
            rand_idx = sample_prior_edges(generator, g.prob, q, g.edge_mask)
            rand_s, rand_r, _, _ = _aux_columns(g.edge_aux[rand_idx])
            prop_s, prop_r = rand_s, rand_r
        else:
            rand_s = rand_r = None
            prop_s, prop_r = g.senders, g.receivers

        # grads reach the scorer only through the q sampled edges'
        # probabilities, so the pass over every edge runs detached and the
        # grad-enabled head runs on the q winners only
        h = model.encode_scorer(g.x, prop_s, prop_r, deterministic=False,
                                generator=generator)
        if g.tile_t:
            seed = draw_seed(generator, dev)
            probs_tiles = model.score_tiles_from_embeddings(
                h.detach(), g.tile_ls, g.tile_lr, g.tile_su, g.tile_rv,
                g.tile_t, g.tile_b, deterministic=False, seed=seed)
            idx_t, _ = sample_edges(generator, probs_tiles, g.tile_prob, q,
                                    cfg.degree_bias_coef,
                                    edge_mask=g.tile_mask)
            sorted_side = ""
            if cfg.sorted_head != "off":
                # ascending tile slots put the senders in near-sorted order
                # (the layout is sender-tile-major)
                idx_t = torch.sort(idx_t).values
                sorted_side = "senders"
            # validity from tile space: padding slots map to edge id 0
            s_s, s_r, sel_valid, reg1_flags = _aux_columns(g.tile_aux[idx_t])
        else:
            with torch.no_grad():
                probs_sample = model.score_from_embeddings(
                    h.detach(), g.senders, g.receivers, deterministic=False,
                    generator=generator)
            idx, _ = sample_edges(generator, probs_sample, g.prob, q,
                                  cfg.degree_bias_coef,
                                  edge_mask=g.edge_mask)
            sorted_side = ""
            if cfg.sorted_head != "off" and g.receiver_band > 0:
                # receiver-sorted edge list: ascending edge ids sort the
                # sampled receivers exactly
                idx = torch.sort(idx).values
                sorted_side = "receivers"
            s_s, s_r, sel_valid, reg1_flags = _aux_columns(g.edge_aux[idx])
        weights = model.score_from_embeddings(
            h, s_s, s_r, deterministic=False, sorted_side=sorted_side,
            generator=generator)

        # padding selections (fewer valid edges than q) get zero weight
        weights = torch.where(sel_valid, weights, 0.0)
        probs_for_loss = weights

        learned_out = _apply_gnn(model, g.x, s_s, s_r, weights, generator)
        loss = masked_cross_entropy(learned_out, g.y, g.train_mask)
        if cfg.reg1:
            # the static edge labels rode the aux-row gather above
            loss = loss + cfg.regularizer1_coef * assortative_bce_flags(
                probs_for_loss, reg1_flags)
        if cfg.reg2:
            loss = loss + cfg.consist_reg_coef * consistency_loss(
                probs_for_loss, s_s, s_r, learned_out, valid=sel_valid)

        if cfg.conditional:
            random_out = _apply_gnn(model, g.x, rand_s, rand_r, None,
                                    generator)
            lf1 = micro_f1(learned_out, g.y, g.train_mask)
            rf1 = micro_f1(random_out, g.y, g.train_mask)
            gate = (lf1 > rf1).detach()
            loss_random = masked_cross_entropy(random_out, g.y, g.train_mask)
            total = torch.where(gate, loss, loss_random)
        else:
            gate = torch.ones((), dtype=torch.bool, device=dev)
            lf1 = rf1 = torch.zeros((), device=dev)
            total = loss
        return total, (gate, lf1, rf1)

    return loss_fn


def _grads(loss, params):
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def make_train_step(cfg: Config, model, opt: DualOptimizer, q: int,
                    max_epoch: int):
    """``step(g, epoch, generator) -> StepMetrics``: one learned-mode update
    of ``model``'s parameters in place. With E <= q the step trains the
    backbone on the full graph, CE only, with the gnn group only
    (reference training_hybrid.py:142-147)."""
    if cfg.mode != "learned":
        raise _not_ported(f"mode={cfg.mode!r}")
    learned_loss = make_learned_loss(cfg, model, q)

    def step(g: Graph, epoch: int, generator: torch.Generator) -> StepMetrics:
        t = temperature_at(epoch, max_epoch, cfg.t_init, cfg.t_min)
        if g.num_edges <= q:
            out = _apply_gnn(model, g.x, g.senders, g.receivers, None,
                             generator)
            loss = masked_cross_entropy(out, g.y, g.train_mask)
            opt.step_gnn_only(_grads(loss, opt.params))
            zero = torch.zeros((), device=g.x.device)
            return StepMetrics(loss.detach(), t, zero, zero, zero)
        total, (gate, lf1, rf1) = learned_loss(g, generator)
        opt.step_learned(_grads(total, opt.params), gate)
        return StepMetrics(total.detach(), t, gate.float(), lf1, rf1)

    return step

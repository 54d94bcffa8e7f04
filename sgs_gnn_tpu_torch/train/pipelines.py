"""Training steps (port of ``train/pipelines.py``: ``make_learned_loss``
with its four pipeline branches and the shared tail, ``make_baseline_loss``
for the random, edge and full modes, and ``make_train_step``).

One step, on one cluster partition. First, with ``conditional`` or
``sparse_edge_mlp``, a degree-prior random q-subgraph
(``sample_prior_edges``): the scorer's propagation graph and the
conditional gate's comparison forward. Then the pipeline's branch turns
the scorer into the q sampled edges' weights:

  * ``two_pass`` (the ``Config`` default; pipelines.py:118-146): the
    scorer over every edge without gradients (K3); sample; sort the winners
    (receiver-sorted edge ids); re-score them with gradients, the encoder
    propagating on the sampled subgraph (K3 forward, K5 backward).
  * ``straight_through`` (:147-156): the scorer over every edge with
    gradients, through the unfused head (``score_receiver_band``: the
    receiver side's VJP is K7); the sampler's straight-through weights
    carry the gradient to every edge through the normalisation.
  * ``hybrid`` exact (``hybrid_rescore=False``, :226-239): the same scoring
    pass, under ``torch.utils.checkpoint`` with ``hybrid_checkpoint``;
    sample on the detached probabilities; the weights are the gathered
    probabilities of the same pass.
  * ``hybrid`` with ``hybrid_rescore`` (:157-225): the encoder with
    gradients; a detached pass over every edge from h (with a tile index
    K6 over every tile slot in tile order, sampled in tile space; without
    one K3); the winners sorted (sender-major in tile space,
    receiver-sorted edge ids otherwise, unless ``sorted_head='off'``); the
    grad-enabled head on them (K3 forward, K5 backward).

With ``dense_subgraph`` (``ops/dense_graph.py``: 'on', or 'auto' where
it engages) and a random subgraph, the step densifies it into an (N, N)
adjacency (padding selections zeroed): the scorer's encoder and the
conditional gate's random forward aggregate with (N, N) products instead
of K1 and K2; two_pass's re-scoring pass densifies the winners (padding
selections kept, as in JAX). The learned backbone's forward on the q
weighted winners stays sparse.

Endpoints, validity and reg1 flags of the winners come from one packed
aux-row gather. The shared tail: the backbone on the sampled edges
weighted by the probabilities, masked CE, reg1 (packed flags), reg2, and
the conditional gate (a second backbone forward on the random subgraph,
micro-F1 of both, ``torch.where`` on the detached comparison); then the
dual-Adam update (``train/optim.py``), the edge group gated.

In PyTorch idiom the module holds the parameters, the optimizer updates
them in place, and the step takes ``(graph, epoch, generator)``: every
random draw of the step comes from that ``torch.Generator``, on the
graph's device. Nothing in the step reads a value back to the host. The
JAX package's TPU gates on this path (the h width limit of the tile
kernel, fused-head VMEM budgets) are not copied.

The baseline modes (random, edge, full) run one backbone forward on a
uniform q-subset (``random_edges``), a degree-prior q-subset
(``sample_prior_edges``) or the whole graph, then masked CE and the third
Adam group with weight decay (``DualOptimizer.step_all``). ``force_small``
(the driver's pick for a padded batch whose valid edge count is <= q)
and E <= q take the whole graph in every mode.

``make_scan_epoch_step`` runs an epoch's steps as replays of CUDA graphs
captured per (shape class, case), the twin of the JAX ``lax.scan`` epoch.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..core.config import Config
from ..core.graph import Graph
from ..core.graphed import Graphs, ShapeClasses
from ..models.scorers import draw_seed
from ..ops.dense_graph import dense_adj, use_dense_subgraph
from ..sparsify.sampling import (random_edges, sample_edges,
                                 sample_prior_edges, temperature_at)
from .losses import (assortative_bce_flags, consistency_loss,
                     masked_cross_entropy, micro_f1)
from .optim import DualOptimizer


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    temperature: float
    conditional_update: torch.Tensor  # 1.0 if the edge scorer was updated
    learned_f1: torch.Tensor
    random_f1: torch.Tensor


def _apply_gnn(model, x, s, r, w, generator):
    return model(x, s, r, w, deterministic=False, generator=generator)


def _aux_columns(aux):
    """(senders, receivers, valid, flags) of packed aux rows, the id columns
    contiguous as the kernels take them."""
    flags = aux[:, 2].contiguous()
    return (aux[:, 0].contiguous(), aux[:, 1].contiguous(), (flags & 4) > 0,
            flags)


def _sample_sorted(cfg: Config, g: Graph, generator, probs, q: int):
    """Sample q edge ids from detached ``probs``; with ``sorted_head`` on a
    receiver-sorted edge list, sort them (ascending edge ids sort the
    sampled receivers exactly) and name the receivers as the head's sorted
    side. Returns (idx, sorted_side)."""
    idx, _ = sample_edges(generator, probs, g.prob, q, cfg.degree_bias_coef,
                          edge_mask=g.edge_mask)
    if cfg.sorted_head != "off" and g.receiver_band > 0:
        return torch.sort(idx).values, "receivers"
    return idx, ""


def _rescore(cfg: Config, model, q: int, g: Graph, generator, prop_s,
             prop_r):
    """The hybrid_rescore branch: grads reach the scorer only through the q
    sampled edges' probabilities, so the pass over every edge runs detached
    and the grad-enabled head runs on the q winners only. Returns the
    winners' (weights, senders, receivers, valid, reg1 flags)."""
    h = model.encode_scorer(g.x, prop_s, prop_r, deterministic=False,
                            generator=generator)
    if g.tile_t:
        seed = draw_seed(generator, g.x.device)
        probs_tiles = model.score_tiles_from_embeddings(
            h.detach(), g.tile_ls, g.tile_lr, g.tile_su, g.tile_rv,
            g.tile_t, g.tile_b, deterministic=False, seed=seed)
        idx_t, _ = sample_edges(generator, probs_tiles, g.tile_prob, q,
                                cfg.degree_bias_coef, edge_mask=g.tile_mask)
        sorted_side = ""
        if cfg.sorted_head != "off":
            # ascending tile slots put the senders in near-sorted order
            # (the layout is sender-tile-major)
            idx_t = torch.sort(idx_t).values
            sorted_side = "senders"
        # validity from tile space: padding slots map to edge id 0
        sel = _aux_columns(g.tile_aux[idx_t])
    else:
        with torch.no_grad():
            probs_sample = model.score_from_embeddings(
                h.detach(), g.senders, g.receivers, deterministic=False,
                generator=generator)
        idx, sorted_side = _sample_sorted(cfg, g, generator, probs_sample, q)
        sel = _aux_columns(g.edge_aux[idx])
    weights = model.score_from_embeddings(
        h, sel[0], sel[1], deterministic=False, sorted_side=sorted_side,
        generator=generator)
    return (weights,) + sel


def make_learned_loss(cfg: Config, model, q: int):
    """``loss_fn(g, generator) -> (total, (gate, lf1, rf1))`` of one batch
    for ``cfg.pipeline`` (module docstring; ``Config`` admits only the three
    pipelines); all three aux values are device tensors."""
    pipeline = cfg.pipeline

    def loss_fn(g: Graph, generator: torch.Generator):
        dev = g.x.device
        n = g.num_nodes
        use_rand = cfg.conditional or cfg.sparse_edge_mlp
        dense = use_rand and use_dense_subgraph(cfg, n, q, dev)
        if use_rand:
            rand_idx = sample_prior_edges(generator, g.prob, q, g.edge_mask)
            rand_s, rand_r, rand_valid, _ = _aux_columns(
                g.edge_aux[rand_idx])
            if dense:
                rand_s, rand_r = dense_adj(rand_s, rand_r, n,
                                           valid=rand_valid), None
            prop_s, prop_r = rand_s, rand_r
        else:
            rand_s = rand_r = None
            prop_s, prop_r = g.senders, g.receivers

        if pipeline == "two_pass":
            # pass 1 over every edge without gradients; pass 3 re-scores
            # the winners with gradients, the scorer's encoder propagating
            # on the sampled subgraph (reference training_two_pass.py:75-77)
            with torch.no_grad():
                probs_full = model.score_edges(
                    g.x, prop_s, prop_r, g.senders, g.receivers,
                    deterministic=False, generator=generator)
            idx, sorted_side = _sample_sorted(cfg, g, generator, probs_full,
                                              q)
            s_s, s_r, sel_valid, reg1_flags = _aux_columns(g.edge_aux[idx])
            # densified without validity, as in JAX: the padding
            # selections' self-loops on the pad node count
            prop = ((dense_adj(s_s, s_r, n), None) if dense
                    else (s_s, s_r))
            weights = model.score_edges(
                g.x, *prop, s_s, s_r, deterministic=False,
                score_sorted_side=sorted_side, generator=generator)
        elif pipeline == "straight_through":
            # one grad-enabled pass over every edge; the straight-through
            # weights carry the gradient through the sampling distribution
            probs_full = model.score_edges(
                g.x, prop_s, prop_r, g.senders, g.receivers,
                deterministic=False, score_receiver_band=g.receiver_band,
                generator=generator)
            idx, weights = sample_edges(generator, probs_full, g.prob, q,
                                        cfg.degree_bias_coef,
                                        edge_mask=g.edge_mask)
            s_s, s_r, sel_valid, reg1_flags = _aux_columns(g.edge_aux[idx])
        elif cfg.hybrid_rescore:
            weights, s_s, s_r, sel_valid, reg1_flags = _rescore(
                cfg, model, q, g, generator, prop_s, prop_r)
        else:
            # exact hybrid: sample on the detached probabilities, then the
            # weights are the same pass's sampled entries
            # (reference training_hybrid.py:86)
            probs_full = model.score_edges(
                g.x, prop_s, prop_r, g.senders, g.receivers,
                deterministic=False, use_remat=cfg.hybrid_checkpoint,
                score_receiver_band=g.receiver_band, generator=generator)
            idx, _ = sample_edges(generator, probs_full.detach(), g.prob, q,
                                  cfg.degree_bias_coef, edge_mask=g.edge_mask)
            s_s, s_r, sel_valid, reg1_flags = _aux_columns(g.edge_aux[idx])
            weights = probs_full[idx]

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


def make_baseline_loss(cfg: Config, model, q: int,
                       force_small: bool = False):
    """``loss_fn(g, generator) -> loss`` of one batch in a baseline mode:
    one backbone forward on the mode's subgraph, masked CE (reference
    training_hybrid.py:149-180)."""
    mode = cfg.mode
    if mode not in ("random", "edge", "full"):
        raise ValueError(mode)

    def loss_fn(g: Graph, generator: torch.Generator):
        if mode == "full" or force_small or g.num_edges <= q:
            s_s, s_r = g.senders, g.receivers
        else:
            if mode == "random":
                idx = random_edges(generator, g.num_edges, q,
                                   edge_mask=g.edge_mask)
            else:
                idx = sample_prior_edges(generator, g.prob, q, g.edge_mask)
            s_s, s_r, _, _ = _aux_columns(g.edge_aux[idx])
        out = _apply_gnn(model, g.x, s_s, s_r, None, generator)
        return masked_cross_entropy(out, g.y, g.train_mask)

    return loss_fn


def param_grads(loss, params):
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def _step_cases(cfg: Config, model, opt: DualOptimizer, q: int):
    """{1: small, 2: sampled}: ``case(g, generator) -> (loss, conditional
    update, learned F1, random F1)``, device scalars, each after its
    update of the parameters in place. Learned mode: the small case is
    full-graph CE with the gnn group only (reference
    training_hybrid.py:142-147), the sampled one the pipeline's loss with
    the gated dual update. Baseline modes: ``make_baseline_loss`` with and
    without ``force_small``, the 'all' group."""
    if cfg.mode != "learned":
        def baseline(force_small):
            loss_fn = make_baseline_loss(cfg, model, q, force_small)

            def case(g: Graph, generator: torch.Generator):
                loss = loss_fn(g, generator)
                opt.step_all(param_grads(loss, opt.params))
                zero = torch.zeros((), device=g.x.device)
                return loss.detach(), zero, zero, zero
            return case
        return {1: baseline(True), 2: baseline(False)}

    learned_loss = make_learned_loss(cfg, model, q)

    def small(g: Graph, generator: torch.Generator):
        out = _apply_gnn(model, g.x, g.senders, g.receivers, None, generator)
        loss = masked_cross_entropy(out, g.y, g.train_mask)
        opt.step_gnn_only(param_grads(loss, opt.params))
        zero = torch.zeros((), device=g.x.device)
        return loss.detach(), zero, zero, zero

    def sampled(g: Graph, generator: torch.Generator):
        total, (gate, lf1, rf1) = learned_loss(g, generator)
        opt.step_learned(param_grads(total, opt.params), gate)
        return total.detach(), gate.float(), lf1, rf1

    return {1: small, 2: sampled}


def make_train_step(cfg: Config, model, opt: DualOptimizer, q: int,
                    max_epoch: int, force_small: bool = False):
    """``step(g, epoch, generator) -> StepMetrics``: one update of
    ``model``'s parameters in place, in ``cfg.mode``.

    Learned mode: with ``force_small`` or E <= q the step trains the
    backbone on the full graph, CE only, with the gnn group only
    (reference training_hybrid.py:142-147); else the pipeline's loss and
    the gated dual update. Baseline modes: ``make_baseline_loss`` and the
    'all' group. E is the graph's edge count, padding included, so the
    driver passes ``force_small=True`` for a padded batch whose VALID edge
    count is <= q (the reference's per-batch decision, made on the host)."""
    cases = _step_cases(cfg, model, opt, q)

    def step(g: Graph, epoch: int, generator: torch.Generator) -> StepMetrics:
        small = force_small or (cfg.mode == "learned" and g.num_edges <= q)
        loss, cond, lf1, rf1 = cases[1 if small else 2](g, generator)
        return StepMetrics(loss, temperature_at(epoch, max_epoch, cfg.t_init,
                                                cfg.t_min), cond, lf1, rf1)

    return step


class ScanEpochStep:
    """The graphed epoch (module ``make_scan_epoch_step``)."""

    def __init__(self, cases, temperature_of, n_batches: int,
                 classes: Optional[ShapeClasses] = None):
        self.cases = cases
        self.temperature_of = temperature_of
        self.n_batches = n_batches
        self.classes = ShapeClasses() if classes is None else classes
        self.graphs = Graphs()
        self.acc = None            # (2,): summed loss, gate count

    def _body(self, case, g: Graph, generator: torch.Generator):
        loss, cond, _, _ = case(g, generator)
        self.acc.add_(torch.stack([loss, cond]))

    def __call__(self, batches, order, actions, epoch: int,
                 generator: torch.Generator, seed_of: Callable[[int], int]):
        dev = batches[0].x.device
        if self.acc is None:
            self.acc = torch.zeros(2, device=dev)
        self.acc.zero_()
        temperature = 1.0
        for bi in order:
            action = actions[bi]
            if action == 0:
                continue
            temperature = self.temperature_of(epoch)
            generator.manual_seed(seed_of(epoch * self.n_batches + bi + 1))
            bufs, pool = self.classes.slot(batches[bi])
            g = bufs.load(batches[bi])
            self.graphs.run((bufs.key, action),
                            functools.partial(self._body, self.cases[action],
                                              g),
                            pool, generator)
        return self.acc[0], self.acc[1], temperature


def make_scan_epoch_step(cfg: Config, model, opt: DualOptimizer, q: int,
                         max_epoch: int, n_batches: int,
                         classes: Optional[ShapeClasses] = None
                         ) -> ScanEpochStep:
    """The whole epoch's training as CUDA graphs: the twin of the JAX
    ``make_scan_epoch_step``, whose ``lax.scan`` runs the per-batch loop's
    updates in one dispatch (pipelines.py:372-480).

    One graph per (shape class, case) holds the forward, the backward and
    the ``DualOptimizer`` update of one batch (``core/graphed.py``). The
    cases are JAX's action table: 0 skip (no train nodes: no graph, no
    replay), 1 small (valid edges <= q), 2 sampled; a class's graphs
    share its input buffers and memory pool (``classes``, which the eval's
    graphs may share). The first batch of each (class, case) runs eagerly,
    as its own step, and the graph is captured right after it; every later
    batch of the pair is copied into the class's buffers and replayed.

    ``epoch_step(batches, order, actions, epoch, generator, seed_of) ->
    (loss_sum, cond_sum, temperature)``: the sums are device scalars (views,
    valid until the next call), the temperature the host schedule's value
    (1.0 when every batch is skipped, as the loop): ``order`` the epoch's global batch ids, ``actions`` the
    table by batch id, and before batch ``bi`` the generator is reseeded
    with ``seed_of(epoch * n_batches + bi + 1)``, the per-batch loop's
    schedule. So the same order, the same per-batch draws and one update
    per batch as the loop (the JAX docstring): a graphed epoch equals the
    eager one up to the order of f32 atomics. Runs on a CUDA device (``classes`` raises on another).
    A tensor-parallel model (``parallel.shard_params_tp``) trains step by
    step, as JAX's does: this raises on one."""
    from ..parallel.tensor_parallel import is_sharded
    if is_sharded(model):
        raise ValueError("make_scan_epoch_step: a tensor-parallel model "
                         "trains step by step (make_train_step)")
    return ScanEpochStep(
        _step_cases(cfg, model, opt, q),
        lambda epoch: temperature_at(epoch, max_epoch, cfg.t_init, cfg.t_min),
        n_batches, classes)

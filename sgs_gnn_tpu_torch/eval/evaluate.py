"""Ensemble evaluation (port of ``eval/evaluate.py``, every mode).

Learned mode: the edge scorer runs in evaluation semantics (no dropout),
so its output is the same for every draw: it is computed once per batch,
with the distribution's normalisation and log-weights
(``sparsify/sampling.py`` ``edge_sampler``), then ``cfg.num_samples_eval``
draws of q edges each feed the backbone and the logits are averaged on the
device. Each split reports (micro-F1 x count, count), so ``aggregate_eval``
weights partitions by their mask sizes as the reference does. The random and edge modes average the logits of
``num_samples_eval`` uniform or degree-prior draws of q edges (unweighted);
the full mode, ``force_small`` and E <= q run the backbone once on the
whole graph. K3 scores, the ordered top-q kernel draws, K1, K2 and K8 run
the backbone.

``learned_ensemble`` is the learned ensemble's one forward, which
serving's ``predict`` (``run/serve.py``) calls too.

``make_scan_eval_step`` runs the eval of every batch in one schedule, the
twin of the JAX ``lax.scan`` eval: as replays of CUDA graphs, one per
(shape class, small flag), or as a loop of eager eval steps; the sums stay
on the device.

With ``core/spans``' device stamps on, an eval step stamps the end of the
scorer, of each draw (``sampler``) and backbone forward, and of the F1s
(``f1``); the eval's host spans are ``eval`` per call and ``eval.batch``
per batch (on the graphed route ``eval.slot``, ``eval.load`` and the
replay inside), and ``aggregate_eval``'s read-back is ``eval.readback``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch

from ..core import spans
from ..core.config import Config
from ..core.graph import Graph
from ..core.graphed import Schedule, ShapeClasses
from ..sparsify.sampling import (edge_sampler, random_edges,
                                 sample_prior_edges)
from ..train.losses import micro_f1

SPLITS = ("train", "val", "test")
KEYS = tuple(f"{s}_{k}" for s in SPLITS for k in ("f1_weighted", "count"))


def score_all(model, g: Graph) -> torch.Tensor:
    """The scorer's probability of every edge of ``g``, in evaluation
    semantics (no dropout)."""
    return model.score_edges(g.x, g.senders, g.receivers, g.senders,
                             g.receivers, True)


def _mean_logits(model, g: Graph, draw, n_draws: int) -> torch.Tensor:
    """The mean of the backbone's logits over ``n_draws`` calls of
    ``draw() -> (edge ids, weights or None)``."""
    total = None
    for _ in range(n_draws):
        idx, w = draw()
        spans.stamp("sampler", g.x.device)
        out = model(g.x, g.senders[idx], g.receivers[idx], w,
                    deterministic=True)
        total = out if total is None else total + out
        spans.stamp("backbone", g.x.device)
    return total / n_draws


def learned_ensemble(cfg: Config, model, q: int, g: Graph,
                     generator: torch.Generator) -> torch.Tensor:
    """The learned ensemble's logits, of the eval and of serving's
    ``predict``: every edge scored once, then ``cfg.num_samples_eval``
    draws of q edges from one ``edge_sampler`` (evaluation semantics),
    each weighted by its probabilities through the backbone, the logits
    averaged."""
    probs = score_all(model, g)
    spans.stamp("scorer", g.x.device)
    draw = edge_sampler(probs, g.prob, q, cfg.degree_bias_coef,
                        istest=True, edge_mask=g.edge_mask)
    return _mean_logits(model, g, lambda: draw(generator),
                        cfg.num_samples_eval)


def make_eval_step(cfg: Config, model, q: int, force_small: bool = False):
    """``eval_step(g, generator) -> {split_f1_weighted, split_count}`` of
    device scalars. With ``mode='full'``, ``force_small`` (a padded batch
    whose valid edge count is <= q) or E <= q the backbone runs once on
    the full graph."""
    mode = cfg.mode
    if mode not in ("learned", "random", "edge", "full"):
        raise ValueError(mode)
    n_draws = cfg.num_samples_eval

    @torch.no_grad()
    def eval_step(g: Graph, generator: torch.Generator
                  ) -> Dict[str, torch.Tensor]:
        if mode == "full" or force_small or g.num_edges <= q:
            logits = model(g.x, g.senders, g.receivers, None,
                           deterministic=True)
            spans.stamp("backbone", g.x.device)
        elif mode == "learned":
            logits = learned_ensemble(cfg, model, q, g, generator)
        elif mode == "random":
            logits = _mean_logits(model, g, lambda: (random_edges(
                generator, g.num_edges, q, edge_mask=g.edge_mask), None),
                n_draws)
        else:
            logits = _mean_logits(model, g, lambda: (sample_prior_edges(
                generator, g.prob, q, g.edge_mask), None), n_draws)
        res = {}
        for split in SPLITS:
            mask = getattr(g, f"{split}_mask")
            cnt = torch.sum(mask.float())
            res[f"{split}_f1_weighted"] = micro_f1(logits, g.y, mask) * cnt
            res[f"{split}_count"] = cnt
        spans.stamp("f1", g.x.device)
        return res

    return eval_step


class ScanEvalStep(Schedule):
    """The eval's per-batch schedule, graphed or looped (module
    ``make_scan_eval_step``)."""

    def __init__(self, steps, classes: Optional[ShapeClasses] = None,
                 loop: bool = False):
        super().__init__("eval", len(KEYS), classes, loop)
        self.steps = steps

    def _body(self, step, g: Graph, generator: torch.Generator):
        spans.stamp("between", g.x.device)
        res = step(g, generator)
        self.acc.add_(torch.stack([res[k] for k in KEYS]))

    def __call__(self, batches, small_flags, generator: torch.Generator,
                 stream_seed: int) -> Dict[str, torch.Tensor]:
        acc = self._zeroed(batches[0].x.device)
        with spans.span("eval"):
            for bi, g in enumerate(batches):
                with spans.span("eval.batch", bi):
                    generator.manual_seed(stream_seed)
                    small = int(small_flags[bi])
                    self._run(g, small,
                              functools.partial(self._body,
                                                self.steps[small]),
                              generator)
            return dict(zip(KEYS, acc.clone().unbind()))


def make_scan_eval_step(cfg: Config, model, q: int,
                        classes: Optional[ShapeClasses] = None,
                        loop: bool = False) -> ScanEvalStep:
    """The ensemble eval of every batch: the twin of the JAX
    ``make_scan_eval_step`` (evaluate.py:87-113), as CUDA graphs, or with
    ``loop`` as a loop of eager eval steps. Graphed, one graph per (shape
    class, small flag) holds one batch's eval with its
    ``num_samples_eval`` draws and the addition of its weighted F1s and
    counts into a device sum (``core/graphed.py``: the first batch of each
    pair runs eagerly, its graph is captured right after).

    ``scan_eval(batches, small_flags, generator, stream_seed) -> {KEYS:
    device scalar}``, the sums over the batches: the generator is
    reseeded with ``stream_seed`` before every batch (JAX's one key for
    every batch), and ``small_flags[bi]`` (valid edges <= q) picks
    ``force_small``. The caller reads the sums back once
    (``aggregate_eval``). The graphed route runs on a CUDA device
    (``classes`` raises on another)."""
    return ScanEvalStep({0: make_eval_step(cfg, model, q),
                         1: make_eval_step(cfg, model, q, force_small=True)},
                        classes, loop)


def aggregate_eval(batch_results: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, float]:
    """Weighted-mean F1 across partition batches; one transfer to the host
    for all of them."""
    with spans.span("eval.readback"):
        table = torch.stack([torch.stack([r[k].float() for k in KEYS])
                             for r in batch_results]).double().sum(0).tolist()
    sums = dict(zip(KEYS, table))
    return {f"{s}_f1": (sums[f"{s}_f1_weighted"] / sums[f"{s}_count"]
                        if sums[f"{s}_count"] > 0 else 0.0)
            for s in SPLITS}


def accumulate_eval_device(acc, result):
    """Running sum of ``eval_step`` results on the device (weighted F1 sums
    and counts add across partitions), so an epoch's eval loop only
    enqueues work and ``aggregate_eval`` reads back once."""
    if acc is None:
        return dict(result)
    return {k: acc[k] + v for k, v in result.items()}

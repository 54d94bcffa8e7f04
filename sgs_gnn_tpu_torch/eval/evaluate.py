"""Ensemble evaluation (port of ``eval/evaluate.py``, every mode).

Learned mode: the edge scorer runs in evaluation semantics (no dropout),
so its output is the same for every draw: it is computed once per batch,
then ``cfg.num_samples_eval`` draws of q edges each feed the backbone and
the logits are averaged on the device. Each split reports (micro-F1 x count,
count), so ``aggregate_eval`` weights partitions by their mask sizes as the
reference does. The random and edge modes average the logits of
``num_samples_eval`` uniform or degree-prior draws of q edges (unweighted);
the full mode, ``force_small`` and E <= q run the backbone once on the
whole graph. No new kernel: K3 scores, K1 and K2 run the backbone.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.config import Config
from ..core.graph import Graph
from ..sparsify.sampling import (random_edges, sample_edges,
                                 sample_prior_edges)
from ..train.losses import micro_f1

SPLITS = ("train", "val", "test")


def make_eval_step(cfg: Config, model, q: int, force_small: bool = False):
    """``eval_step(g, generator) -> {split_f1_weighted, split_count}`` of
    device scalars. With ``mode='full'``, ``force_small`` (a padded batch
    whose valid edge count is <= q) or E <= q the backbone runs once on
    the full graph."""
    mode = cfg.mode
    if mode not in ("learned", "random", "edge", "full"):
        raise ValueError(mode)
    n_draws = cfg.num_samples_eval

    def ensemble(g: Graph, draw):
        total = None
        for _ in range(n_draws):
            idx, w = draw()
            out = model(g.x, g.senders[idx], g.receivers[idx], w,
                        deterministic=True)
            total = out if total is None else total + out
        return total / n_draws

    @torch.no_grad()
    def eval_step(g: Graph, generator: torch.Generator
                  ) -> Dict[str, torch.Tensor]:
        if mode == "full" or force_small or g.num_edges <= q:
            logits = model(g.x, g.senders, g.receivers, None,
                           deterministic=True)
        elif mode == "learned":
            probs = model.score_edges(g.x, g.senders, g.receivers, g.senders,
                                      g.receivers, True)
            logits = ensemble(g, lambda: sample_edges(
                generator, probs, g.prob, q, cfg.degree_bias_coef,
                istest=True, edge_mask=g.edge_mask))
        elif mode == "random":
            logits = ensemble(g, lambda: (random_edges(
                generator, g.num_edges, q, edge_mask=g.edge_mask), None))
        else:
            logits = ensemble(g, lambda: (sample_prior_edges(
                generator, g.prob, q, g.edge_mask), None))
        res = {}
        for split in SPLITS:
            mask = getattr(g, f"{split}_mask")
            cnt = torch.sum(mask.float())
            res[f"{split}_f1_weighted"] = micro_f1(logits, g.y, mask) * cnt
            res[f"{split}_count"] = cnt
        return res

    return eval_step


def aggregate_eval(batch_results: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, float]:
    """Weighted-mean F1 across partition batches; one transfer to the host
    for all of them."""
    keys = [f"{s}_{k}" for s in SPLITS for k in ("f1_weighted", "count")]
    table = torch.stack([torch.stack([r[k].float() for k in keys])
                         for r in batch_results]).double().sum(0).tolist()
    sums = dict(zip(keys, table))
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

"""Ensemble evaluation (port of ``eval/evaluate.py``, learned mode).

The edge scorer runs in evaluation semantics (no dropout), so its output is
the same for every draw: it is computed once per batch, then
``cfg.num_samples_eval`` draws of q edges each feed the backbone and the
logits are averaged on the device. Each split reports (micro-F1 x count,
count), so ``aggregate_eval`` weights partitions by their mask sizes as the
reference does. No new kernel: K3 scores, K1 and K2 run the backbone.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.config import Config
from ..core.graph import Graph
from ..sparsify.sampling import sample_edges
from ..train.losses import micro_f1

SPLITS = ("train", "val", "test")


def make_eval_step(cfg: Config, model, q: int):
    """``eval_step(g, generator) -> {split_f1_weighted, split_count}`` of
    device scalars. With E <= q or ``mode='full'`` the backbone runs once
    on the full graph."""
    mode = cfg.mode
    if mode not in ("learned", "full"):
        raise NotImplementedError(
            f"mode={mode!r}: the port evaluates the learned mode so far; the "
            "baseline modes come with a later slice (ROADMAP.md)")
    n_draws = cfg.num_samples_eval

    @torch.no_grad()
    def eval_step(g: Graph, generator: torch.Generator
                  ) -> Dict[str, torch.Tensor]:
        if mode == "full" or g.num_edges <= q:
            logits = model(g.x, g.senders, g.receivers, None,
                           deterministic=True)
        else:
            probs = model.score_edges(g.x, g.senders, g.receivers, g.senders,
                                      g.receivers, True)
            total = None
            for _ in range(n_draws):
                idx, w = sample_edges(generator, probs, g.prob, q,
                                      cfg.degree_bias_coef, istest=True,
                                      edge_mask=g.edge_mask)
                out = model(g.x, g.senders[idx], g.receivers[idx], w,
                            deterministic=True)
                total = out if total is None else total + out
            logits = total / n_draws
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

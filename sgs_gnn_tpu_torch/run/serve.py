"""Serving API: the graph sparsifier product surface (port of
``run/serve.py``).

  * ``sparsify`` scores all edges and draws a q-edge sparse subgraph (edge
    ids and their learned weights).
  * ``predict`` averages class logits over ``cfg.num_samples_eval`` sampled
    subgraphs (the evaluation ensemble without the metrics).

Both run without autograd and in the model's evaluation semantics (no
dropout). Where JAX takes a PRNG key they take a ``torch.Generator`` on the
graph's device; the model and the graph must be on the same device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import Config
from ..core.graph import Graph
from ..sparsify.sampling import sample_edges


class SparsifiedGraph(NamedTuple):
    senders: torch.Tensor     # (q,)
    receivers: torch.Tensor   # (q,)
    weights: torch.Tensor     # (q,) learned edge probabilities of kept edges
    edge_ids: torch.Tensor    # (q,) indices into the original edge list
    probs: torch.Tensor       # (E,) full learned edge-probability vector


def _score_all(model, g: Graph):
    return model.score_edges(g.x, g.senders, g.receivers, g.senders,
                             g.receivers, True)


def make_sparsifier(cfg: Config, model, q: int):
    """Returns ``sparsify(graph, generator) -> SparsifiedGraph``."""

    @torch.no_grad()
    def sparsify(g: Graph, generator: torch.Generator) -> SparsifiedGraph:
        probs = _score_all(model, g)
        idx, w = sample_edges(generator, probs, g.prob, q,
                              cfg.degree_bias_coef, istest=True,
                              edge_mask=g.edge_mask)
        return SparsifiedGraph(senders=g.senders[idx],
                               receivers=g.receivers[idx], weights=w,
                               edge_ids=idx, probs=probs)

    return sparsify


def make_predictor(cfg: Config, model, q: int):
    """Returns ``predict(graph, generator) -> (logits, labels)``: the mean
    of the backbone's logits over ``cfg.num_samples_eval`` draws of q
    edges; with E <= q or ``cfg.mode == 'full'`` the full graph, once."""
    n_draws = cfg.num_samples_eval

    @torch.no_grad()
    def predict(g: Graph, generator: torch.Generator):
        if g.num_edges <= q or cfg.mode == "full":
            logits = model(g.x, g.senders, g.receivers, deterministic=True)
            return logits, torch.argmax(logits, dim=-1)
        probs = _score_all(model, g)
        total = None
        for _ in range(n_draws):
            idx, w = sample_edges(generator, probs, g.prob, q,
                                  cfg.degree_bias_coef, istest=True,
                                  edge_mask=g.edge_mask)
            out = model(g.x, g.senders[idx], g.receivers[idx], w,
                        deterministic=True)
            total = out if total is None else total + out
        logits = total / n_draws
        return logits, torch.argmax(logits, dim=-1)

    return predict

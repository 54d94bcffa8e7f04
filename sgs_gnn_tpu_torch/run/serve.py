"""Serving API: the graph sparsifier product surface (port of
``run/serve.py``).

  * ``sparsify`` scores all edges and draws a q-edge sparse subgraph (edge
    ids and their learned weights).
  * ``predict`` averages class logits over ``cfg.num_samples_eval`` sampled
    subgraphs (the evaluation ensemble without the metrics).

Both run without autograd and in the model's evaluation semantics (no
dropout). Where JAX takes a PRNG key they take a ``torch.Generator`` on the
graph's device; the model and the graph must be on the same device.

On a CUDA device each call replays a CUDA graph, as JAX replays the jitted
call: one graph per graph shape, captured right after the first call with
that shape runs eagerly (``core/graphed.py``). The graph's tensors are
copied into the shape's input buffers first, the draws are those the
eager call would make with the caller's generator, which advances by the
same amount (a new generator on every call replays the same graph), and
the outputs are copies the next call does not overwrite. The graphs read the model's parameters where they
are: change them in place (``load_state_dict`` does). The returned
function's ``eager`` attribute is the same call without graphs.

With ``core/spans`` on, a graphed call is the span ``serve.request`` (id:
the call's number) with ``serve.slot``, ``serve.load``, the replay
(``serve.replay``, or the eager run and capture) and ``serve.clone``
inside; the device stamps mark the end of the scorer and of each draw
(``sampler``) and backbone forward.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from ..core.config import Config
from ..core.graph import Graph
from ..core import graphed, spans
from ..eval.evaluate import learned_ensemble, score_all
from ..sparsify.sampling import sample_edges


class SparsifiedGraph(NamedTuple):
    senders: torch.Tensor     # (q,)
    receivers: torch.Tensor   # (q,)
    weights: torch.Tensor     # (q,) learned edge probabilities of kept edges
    edge_ids: torch.Tensor    # (q,) indices into the original edge list
    probs: torch.Tensor       # (E,) full learned edge-probability vector


def _graphed(fn):
    """``fn(graph, generator)``, replayed from CUDA graphs on a CUDA
    device (module docstring; ``graphed.run_batch``); ``.graphs`` holds
    them, ``.eager`` is ``fn``."""
    classes, graphs = graphed.ShapeClasses(), graphed.Graphs(name="serve")
    calls = itertools.count()

    def call(g: Graph, generator: torch.Generator):
        if not graphed.runs_graphs(g.x.device):
            return fn(g, generator)
        with spans.span("serve.request", next(calls)):
            n_graphs = len(graphs)
            out = graphed.run_batch(classes, graphs, g, None, fn, generator)
            if len(graphs) == n_graphs:
                # a replay's static outputs: the caller gets copies
                with spans.span("serve.clone"):
                    clones = [t.clone() for t in out]
                    out = (type(out)(*clones) if hasattr(out, "_fields")
                           else tuple(clones))
            return out

    call.graphs, call.eager = graphs, fn
    return call


def make_sparsifier(cfg: Config, model, q: int):
    """Returns ``sparsify(graph, generator) -> SparsifiedGraph``."""

    @torch.no_grad()
    def sparsify(g: Graph, generator: torch.Generator) -> SparsifiedGraph:
        spans.stamp("between", g.x.device)
        probs = score_all(model, g)
        spans.stamp("scorer", g.x.device)
        idx, w = sample_edges(generator, probs, g.prob, q,
                              cfg.degree_bias_coef, istest=True,
                              edge_mask=g.edge_mask)
        spans.stamp("sampler", g.x.device)
        return SparsifiedGraph(senders=g.senders[idx],
                               receivers=g.receivers[idx], weights=w,
                               edge_ids=idx, probs=probs)

    return _graphed(sparsify)


def make_predictor(cfg: Config, model, q: int):
    """Returns ``predict(graph, generator) -> (logits, labels)``: the
    learned ensemble (``eval/evaluate.py`` ``learned_ensemble``: the mean
    of the backbone's logits over ``cfg.num_samples_eval`` draws of q
    edges); with E <= q or ``cfg.mode == 'full'`` the full graph, once."""

    @torch.no_grad()
    def predict(g: Graph, generator: torch.Generator):
        spans.stamp("between", g.x.device)
        if g.num_edges <= q or cfg.mode == "full":
            logits = model(g.x, g.senders, g.receivers, deterministic=True)
            spans.stamp("backbone", g.x.device)
        else:
            logits = learned_ensemble(cfg, model, q, g, generator)
        return logits, torch.argmax(logits, dim=-1)

    return _graphed(predict)

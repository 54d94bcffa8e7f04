"""Learned edge sampling with straight-through weights (port of
``sparsify/sampling.py``).

Training draws mix the learned distribution with the degree/ER prior,
``(1-beta) p/sum(p) + beta prior``; test draws (``istest=True``) do not.
The returned weight of a selected edge e has the value ``edge_probs[e]``
and, under autograd, the straight-through gradient
``d w_e = st[e] * d edge_probs[e] + edge_probs[e] * d samples[e]``.
Every draw returns its edge ids in ascending order (``ops/sampling_ops.py``
``topq_ordered``): on a receiver-sorted edge list the sampled receivers
come sorted. :func:`edge_sampler` draws several times from one
distribution and normalises it and takes its logarithm once.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.sampling_ops import (gumbel_topk, gumbel_topk_logw, log_weights,
                                uniform_topk)

_EPS = 1e-12


def _normalized(edge_probs, edge_mask):
    if edge_mask is not None:
        edge_probs = torch.where(edge_mask, edge_probs, 0.0)
    return edge_probs / (torch.sum(edge_probs) + _EPS)


def edge_sampler(edge_probs, prior, q: int, degree_bias_coef: float,
                 istest: bool = False,
                 edge_mask: Optional[torch.Tensor] = None
                 ) -> Callable[[torch.Generator],
                               Tuple[torch.Tensor, torch.Tensor]]:
    """``draw(generator) -> (idx, weights)``: the draws of
    :func:`sample_edges` from one distribution, whose normalisation and
    log-weights are computed here, once."""
    samples = _normalized(edge_probs, edge_mask)
    if not istest:
        prior_ = (torch.where(edge_mask, prior, 0.0) if edge_mask is not None
                  else prior)
        samples = (1.0 - degree_bias_coef) * samples \
            + degree_bias_coef * prior_
    logw = log_weights(samples.detach())

    def draw(generator):
        idx = gumbel_topk_logw(generator, logw, q, mask=edge_mask)
        sel = samples[idx]
        straight_through = (1.0 - sel).detach() + sel
        weights = torch.clamp(edge_probs[idx] * straight_through, 0.0, 1.0)
        return idx, weights

    return draw


def sample_edges(generator, edge_probs, prior, q: int,
                 degree_bias_coef: float, istest: bool = False,
                 edge_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample q edge indices ~ learned distribution; return (idx int32,
    ascending; straight-through weights float32)."""
    return edge_sampler(edge_probs, prior, q, degree_bias_coef, istest,
                        edge_mask)(generator)


def sample_prior_edges(generator, prior, q: int,
                       edge_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sample q edges ~ softmax(prior) (the reference's 'edge' mode and the
    conditional gate's random subgraph)."""
    logits = (torch.where(edge_mask, prior, float("-inf"))
              if edge_mask is not None else prior)
    p = torch.softmax(logits, dim=0)
    return gumbel_topk(generator, p, q, mask=edge_mask)


def random_edges(generator, num_edges: int, q: int,
                 edge_mask: Optional[torch.Tensor] = None,
                 device="cuda") -> torch.Tensor:
    """Uniform q-subset of the edges (reference random_edge_sampling)."""
    if edge_mask is not None:
        device = edge_mask.device
    return uniform_topk(generator, num_edges, q, mask=edge_mask,
                        device=device)


def temperature_at(epoch, max_epoch: int, t_init: float,
                   t_min: float) -> float:
    """Linear annealing ``max(t_min, t_init - epoch*(t_init-t_min)/max_epoch)``
    (tracked for parity; the live sampler does not read it)."""
    r = (t_init - t_min) / max_epoch
    return max(t_min, t_init - epoch * r)

"""Learned edge sampling with straight-through weights (port of
``sparsify/sampling.py``).

Training draws mix the learned distribution with the degree/ER prior,
``(1-beta) p/sum(p) + beta prior``; test draws (``istest=True``) do not.
The returned weight of a selected edge e has the value ``edge_probs[e]``
and, under autograd, the straight-through gradient
``d w_e = st[e] * d edge_probs[e] + edge_probs[e] * d samples[e]``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.sampling_ops import gumbel_topk

_EPS = 1e-12


def _normalized(edge_probs, edge_mask):
    if edge_mask is not None:
        edge_probs = torch.where(edge_mask, edge_probs, 0.0)
    return edge_probs / (torch.sum(edge_probs) + _EPS)


def sample_edges(generator, edge_probs, prior, q: int,
                 degree_bias_coef: float, istest: bool = False,
                 edge_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample q edge indices ~ learned distribution; return (idx int32,
    straight-through weights float32)."""
    samples = _normalized(edge_probs, edge_mask)
    if not istest:
        prior_ = (torch.where(edge_mask, prior, 0.0) if edge_mask is not None
                  else prior)
        samples = (1.0 - degree_bias_coef) * samples \
            + degree_bias_coef * prior_
    idx = gumbel_topk(generator, samples.detach(), q, mask=edge_mask)
    sel = samples[idx]
    straight_through = (1.0 - sel).detach() + sel
    weights = torch.clamp(edge_probs[idx] * straight_through, 0.0, 1.0)
    return idx, weights


def sample_prior_edges(generator, prior, q: int,
                       edge_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sample q edges ~ softmax(prior) (the reference's 'edge' mode and the
    conditional gate's random subgraph)."""
    logits = (torch.where(edge_mask, prior, float("-inf"))
              if edge_mask is not None else prior)
    p = torch.softmax(logits, dim=0)
    return gumbel_topk(generator, p, q, mask=edge_mask)

"""Edge-probability scorers (port of ``models/scorers.py``; this slice
carries the GCN scorer).

An encoder produces node embeddings h, then a shared score head maps each
edge (u, v) -> sigmoid(fc2(relu(fc1([h_u * h_v || h_u - h_v])))):

    encode(x, prop_senders, prop_receivers) -> h         (N, hidden)
    score_from(h, senders, receivers)       -> probs     (E,)
    forward(...) == score_from(encode(...), score edges)

``score_from`` always goes through ``ops.score_head_sampled``, which
launches the CUDA kernel for tensors on the card and runs the plain version
on the CPU. fc1 is stored as one ``nn.Linear(2F, K)`` (the JAX tree's
concat kernel, transposed) and split into its product half W1a and
difference half W1b at the call, so no (E, 2F) concat is formed.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import GCNConv
from ..ops.score_sampled import score_head_sampled

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``lecun_normal`` (truncated normal, variance 1/fan_in) on an
    (out, in) weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


class _ScoreHead(nn.Module):
    """fc1 -> ReLU -> dropout -> fc2 -> sigmoid over [h_u*h_v || h_u-h_v]."""

    def __init__(self, hidden_dim: int, dropout_prob: float, generator=None):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.fc1 = nn.Linear(2 * hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 1)
        for lin in (self.fc1, self.fc2):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, h, senders, receivers, deterministic: bool = True):
        rate = 0.0 if deterministic else self.dropout_prob
        return score_head_sampled(h, self.fc1.weight.t(), self.fc1.bias,
                                  self.fc2.weight.t(), self.fc2.bias,
                                  senders, receivers, drop_rate=rate)


class EdgeProbGCN(nn.Module):
    """2-layer GCN encoder + score head: the default scorer
    (``edge_mlp_type='GCN'``)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 dropout_prob: float = 0.2, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_prob = dropout_prob
        # registration order fixes the init order from one generator
        self.head = _ScoreHead(hidden_dim, dropout_prob, generator)
        self.gcn1 = GCNConv(in_channels, hidden_dim, dtype, generator)
        self.gcn2 = GCNConv(hidden_dim, hidden_dim, dtype, generator)

    def encode(self, x, prop_senders, prop_receivers,
               deterministic: bool = True):
        h = self.gcn1(x, prop_senders, prop_receivers)
        h = nn.functional.dropout(torch.relu(h), self.dropout_prob,
                                  training=not deterministic)
        h = torch.relu(self.gcn2(h, prop_senders, prop_receivers))
        return h.to(self.dtype)

    def score_from(self, h, senders, receivers, deterministic: bool = True):
        return self.head(h.to(self.dtype), senders, receivers, deterministic)

    def forward(self, x, prop_senders, prop_receivers, score_senders,
                score_receivers, deterministic: bool = True):
        h = self.encode(x, prop_senders, prop_receivers, deterministic)
        return self.score_from(h, score_senders, score_receivers,
                               deterministic)

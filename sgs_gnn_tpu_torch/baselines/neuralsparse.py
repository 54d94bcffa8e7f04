"""NeuralSparse baseline: k-per-node Gumbel top-k sparsification (port of
``baselines/neuralsparse.py``; reference
Notebooks/1KDDNeuralSparseoptimized.ipynb: ``GumbleGCN``,
``get_neuralsparse_edge_scores``, ``select_topk_per_node``).

An MLP scores each edge from its endpoint features, Gumbel noise is added,
and each node keeps its top-k incoming edges; a 2-layer GCN trains on the
masked graph with straight-through gradients. The endpoint gathers'
backward is K1, the GCN layers' degrees K2 and their aggregation K1
(``models/layers.py`` ``GCNConv``). Randomness (the Gumbel noise, the
layer dropout) comes from the caller's ``torch.Generator``.

Per-node top-k with static shapes: rank every edge within its receiver's
segment after sorting by (receiver ascending, score descending) and keep
rank < k: one O(E log E) sort pair, no per-node loop.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device, torch_dtype
from ..models.layers import GCNConv, dense, linear
from ..ops.dropout import dropout
from ..ops.edge_gather import gather_rows


def per_node_topk_mask(scores, receivers, num_nodes: int, k: int):
    """(E,) bool keeping each receiver's k highest-scoring edges.

    JAX's ``lexsort((-scores, receivers))`` is two stable sorts, the minor
    key first, so equal keys keep their index order as lexsort's do; a
    segment's start is carried forward by ``cummax`` (JAX's
    ``associative_scan(maximum)``), and an edge's rank is its sorted
    position minus its segment's start. ``num_nodes`` is unused, as in
    JAX."""
    e = scores.shape[0]
    order = torch.sort(-scores, stable=True).indices
    order = order[torch.sort(receivers[order], stable=True).indices]
    sorted_recv = receivers[order]
    pos = torch.arange(e, device=scores.device)
    is_start = torch.ones(e, dtype=torch.bool, device=scores.device)
    is_start[1:] = sorted_recv[1:] != sorted_recv[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    keep = torch.zeros(e, dtype=torch.bool, device=scores.device)
    keep[order] = (pos - seg_start) < k
    return keep


def gumbel(generator, shape, device):
    """Standard Gumbel noise, -log(-log u) of uniform draws in (0, 1) from
    ``generator`` (``jax.random.gumbel``'s distribution)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


class NeuralSparseGCN(nn.Module):
    """Edge-scoring MLP + k-per-node Gumbel selection + 2-layer GCN. The
    parameters are flax's (``score_proj``, ``score_out``, ``gcn1``,
    ``gcn2``), drawn on the CPU from ``generator`` and moved to
    ``device``; ``dtype`` is the compute dtype of the projections."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 k: int = 5, dropout_prob: float = 0.3, dtype="float32",
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.k, self.dropout_prob = k, dropout_prob
        self.dtype = torch_dtype(dtype)
        self.score_proj = dense(in_channels, hidden_dim, True, generator)
        self.score_out = dense(2 * hidden_dim, 1, True, generator)
        self.gcn1 = GCNConv(in_channels, hidden_dim, self.dtype, generator)
        self.gcn2 = GCNConv(hidden_dim, num_classes, self.dtype, generator)
        self.to(dev)

    def forward(self, x, senders, receivers, generator=None,
                temperature: float = 1.0, deterministic: bool = True):
        """Logits (N, num_classes). The Gumbel noise is drawn from
        ``generator`` always, the layer dropout when not
        ``deterministic`` (JAX's argument order, ``generator`` in place of
        ``key``)."""
        n = x.shape[0]
        hu = linear(x, self.score_proj, self.dtype)
        feats = torch.cat([gather_rows(hu, senders),
                           gather_rows(hu, receivers)], dim=-1)
        logits = linear(torch.relu(feats), self.score_out,
                        self.dtype)[:, 0].float()
        noisy = (logits + gumbel(generator, logits.shape, x.device)) \
            / temperature
        keep = per_node_topk_mask(noisy, receivers, n, self.k)
        soft = torch.sigmoid(noisy)
        # straight-through: the hard 0/1 mask forward, the sigmoid backward
        w = (keep.float() - soft).detach() + soft
        h = torch.relu(self.gcn1(x, senders, receivers, w))
        h = dropout(h, self.dropout_prob, generator,
                    training=not deterministic)
        return self.gcn2(h, senders, receivers, w)

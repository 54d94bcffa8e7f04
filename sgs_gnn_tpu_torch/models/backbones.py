"""GNN backbones, each owning an edge-probability scorer (port of
``models/backbones.py``; this slice carries the GCN backbone with the GCN
scorer).

Submodule names follow the JAX tree (``gcn1``/``gcn2``/``edge_prob_mlp``):
the dual optimizer of the training slice partitions parameters by name, and
``models.convert.params_from_jax`` maps the flax tree onto them.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import GCNConv
from .scorers import EdgeProbGCN
from ..core.device import resolve_device, torch_dtype


class GNNModel(nn.Module):
    """2-layer GCN backbone. Per-edge weights (the sampled probabilities)
    enter the symmetric normalisation."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 dropout_prob: float = 0.3, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.edge_prob_mlp = EdgeProbGCN(in_channels, hidden_dim,
                                         dropout_prob, dtype, generator)
        self.gcn1 = GCNConv(in_channels, hidden_dim, dtype, generator)
        self.gcn2 = GCNConv(hidden_dim, num_classes, dtype, generator)

    def forward(self, x, senders, receivers, edge_weight=None,
                deterministic: bool = True):
        h = torch.relu(self.gcn1(x, senders, receivers, edge_weight))
        h = nn.functional.dropout(h, self.dropout_prob,
                                  training=not deterministic)
        return self.gcn2(h, senders, receivers, edge_weight)

    def score_edges(self, x, prop_senders, prop_receivers, score_senders,
                    score_receivers, deterministic: bool = True):
        return self.edge_prob_mlp(x, prop_senders, prop_receivers,
                                  score_senders, score_receivers,
                                  deterministic)


def get_model(gnn: str, in_channels: int, hidden_dim: int, num_classes: int,
              dropout_prob: float = 0.3, edge_mlp_type: str = "GCN",
              dtype="float32", device="cuda", generator=None) -> GNNModel:
    """Backbone factory. ``dtype`` is the compute dtype of the matmuls
    (parameters stay float32). Parameters are drawn on the CPU from
    ``generator`` (flax's initialisers), so one seed gives the same weights
    on every device, then moved to ``device``."""
    if gnn != "GCN" or edge_mlp_type != "GCN":
        raise NotImplementedError(
            f"GNN={gnn!r} with edge_mlp_type={edge_mlp_type!r}: the port "
            "carries the GCN backbone with the GCN scorer so far; the other "
            "backbones and scorers come with a later slice (ROADMAP.md)")
    dev = resolve_device(device)
    model = GNNModel(in_channels, hidden_dim, num_classes, dropout_prob,
                     torch_dtype(dtype), generator)
    return model.to(dev)

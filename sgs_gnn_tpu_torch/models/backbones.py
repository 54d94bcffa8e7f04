"""GNN backbones, each owning an edge-probability scorer (port of
``models/backbones.py``): ``GNNModel`` (GCN), ``GINModel``, ``GATModel``
and ``ChebModel``, each with the MLP, GSAGE or GCN scorer; and
``GCNIIModel``, a deep backbone the JAX package does not have.

Submodule names follow the JAX tree (``gcn1``/``gcn2``, ``GIN_conv1``/
``GIN_conv2``, ``GAT_conv1``/``GAT_conv2``, ``edge_prob_mlp``; GCNII's
``GCNII_in``, ``GCNII_conv<l>``, ``GCNII_out``): the dual
optimizer (``train/optim.py``) partitions parameters by name, and
``models.convert.params_from_jax`` maps the flax tree onto them.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (ChebConv, GATConv, GCN2Conv, GCNConv, GINConv,
                     col_block, dense, gcn_degree_factors, linear,
                     masked_weights)
from .scorers import get_edge_mlp
from ..core.device import resolve_device, torch_dtype
from ..ops.dropout import dropout


class _Backbone(nn.Module):
    """Shared part of the backbones: the scorer (registered first, so one
    generator draws it first), the forward (:meth:`stack`: two layers with
    dropout between them), and the scorer's entry points. A subclass
    registers its two layers under their JAX names and returns them from
    ``layers``. The edge weights go to both layers; GIN and GAT ignore
    them, as PyG's do. The halo hooks (``exchange``, ``edge_mask``;
    ``models/layers.py``) pass through to both layers and to the scorer.
    Under tensor parallelism the dropout between the layers masks this
    rank's block of the whole mask where the first layer's output is
    column-sharded (GCN, Cheb); GIN's layers and GAT's give whole rows."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.edge_prob_mlp = get_edge_mlp(in_channels, hidden_dim,
                                          dropout_prob, edge_mlp_type, dtype,
                                          generator)

    def layers(self):
        raise NotImplementedError

    def forward(self, x, senders, receivers, edge_weight=None,
                deterministic: bool = True, generator=None, exchange=None,
                edge_mask=None):
        """The logits: :meth:`stack` on the inputs, the one entry of every
        backbone."""
        return self.stack(x, senders, receivers, edge_weight,
                          not deterministic, generator, exchange, edge_mask)

    def stack(self, x, senders, receivers, edge_weight, training: bool,
              generator, exchange, edge_mask):
        """The two layers of :meth:`layers`, dropout between them; a
        deeper backbone overrides it."""
        layer1, layer2 = self.layers()
        h = torch.relu(layer1(x, senders, receivers, edge_weight, exchange,
                              edge_mask))
        h = dropout(h, self.dropout_prob, generator, training=training,
                    shard=col_block(layer1))
        return layer2(h, senders, receivers, edge_weight, exchange,
                      edge_mask)

    def score_edges(self, x, prop_senders, prop_receivers, score_senders,
                    score_receivers, deterministic: bool = True,
                    use_remat: bool = False, score_receiver_band: int = 0,
                    score_sorted_side: str = "", generator=None):
        """The scorer (encoder on the prop edges, head on the score edges);
        see ``_EdgeScorer.score_from`` for the band and remat options."""
        return self.edge_prob_mlp(x, prop_senders, prop_receivers,
                                  score_senders, score_receivers,
                                  deterministic, use_remat,
                                  score_receiver_band, score_sorted_side,
                                  generator)

    def encode_scorer(self, x, prop_senders, prop_receivers,
                      deterministic: bool = True, generator=None,
                      exchange=None, edge_mask=None):
        """Scorer encoder only -> node embeddings (hybrid_rescore path)."""
        return self.edge_prob_mlp.encode(x, prop_senders, prop_receivers,
                                         deterministic, generator, exchange,
                                         edge_mask)

    def score_from_embeddings(self, h, senders, receivers,
                              deterministic: bool = True,
                              use_remat: bool = False,
                              receiver_band: int = 0,
                              sorted_side: str = "", generator=None,
                              exchange=None):
        """Score head only, over precomputed scorer embeddings."""
        return self.edge_prob_mlp.score_from(h, senders, receivers,
                                             deterministic, use_remat,
                                             receiver_band, sorted_side,
                                             generator, exchange)

    def score_tiles_from_embeddings(self, h, tile_ls, tile_lr, tile_su,
                                    tile_rv, t: int, bk: int,
                                    deterministic: bool = True, seed=0):
        """Detached tile-pair scoring of every slot (ops/score_tiles.py)."""
        return self.edge_prob_mlp.score_tiles(h, tile_ls, tile_lr, tile_su,
                                              tile_rv, t, bk, deterministic,
                                              seed)


class GNNModel(_Backbone):
    """2-layer GCN backbone. Per-edge weights (the sampled probabilities)
    enter the symmetric normalisation."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
                 heads: int = 1, dtype=torch.float32, generator=None):
        super().__init__(in_channels, hidden_dim, dropout_prob,
                         edge_mlp_type, dtype, generator)
        self.gcn1 = GCNConv(in_channels, hidden_dim, dtype, generator)
        self.gcn2 = GCNConv(hidden_dim, num_classes, dtype, generator)

    def layers(self):
        return self.gcn1, self.gcn2


class GINModel(_Backbone):
    """2-layer GIN; edge weights are ignored."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
                 heads: int = 1, dtype=torch.float32, generator=None):
        super().__init__(in_channels, hidden_dim, dropout_prob,
                         edge_mlp_type, dtype, generator)
        self.GIN_conv1 = GINConv(in_channels, hidden_dim, hidden_dim, dtype,
                                 generator)
        self.GIN_conv2 = GINConv(hidden_dim, hidden_dim, num_classes, dtype,
                                 generator)

    def layers(self):
        return self.GIN_conv1, self.GIN_conv2


class GATModel(_Backbone):
    """2-layer GAT: ``heads`` concatenated heads, then one head averaged
    (the reference's PyG default is heads=1); edge weights are ignored."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
                 heads: int = 1, dtype=torch.float32, generator=None):
        super().__init__(in_channels, hidden_dim, dropout_prob,
                         edge_mlp_type, dtype, generator)
        self.GAT_conv1 = GATConv(in_channels, hidden_dim, heads=heads,
                                 concat=True, dtype=dtype,
                                 generator=generator)
        self.GAT_conv2 = GATConv(heads * hidden_dim, num_classes, heads=1,
                                 concat=False, dtype=dtype,
                                 generator=generator)

    def layers(self):
        return self.GAT_conv1, self.GAT_conv2


class ChebModel(_Backbone):
    """2-layer ChebConv with K=1 (graph-free: X Theta_0 + b per layer)."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
                 heads: int = 1, dtype=torch.float32, generator=None):
        super().__init__(in_channels, hidden_dim, dropout_prob,
                         edge_mlp_type, dtype, generator)
        self.gcn1 = ChebConv(in_channels, hidden_dim, K=1, dtype=dtype,
                             generator=generator)
        self.gcn2 = ChebConv(hidden_dim, num_classes, K=1, dtype=dtype,
                             generator=generator)

    def layers(self):
        return self.gcn1, self.gcn2


class GCNIIModel(_Backbone):
    """GCNII (Chen et al., ICML 2020, Eq. 5) at its published PPI setting
    by default: h0 = relu(x W_in + b_in), then ``layers`` GCN2Conv layers
    of ``width`` columns, each followed by a ReLU, then the logits h W_out +
    b_out. Dropout at ``dropout_prob`` before each of the layers (input,
    convolutions, output) when training, as the paper's model has it. The
    edge weights enter GCN's normalisation of every layer. ``nhid`` is the
    scorer's width alone. The halo exchange is refused (no layer code for
    an extended table), as are tensor parallelism
    (``parallel.shard_params_tp``) and ``dense_subgraph='on'``
    (``core/config.py``)."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int,
                 dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
                 heads: int = 1, dtype=torch.float32, generator=None,
                 layers: int = 9, width: int = 2048, alpha: float = 0.5,
                 lam: float = 1.0):
        super().__init__(in_channels, hidden_dim, dropout_prob,
                         edge_mlp_type, dtype, generator)
        self.dtype = dtype
        self.GCNII_in = dense(in_channels, width, True, generator)
        for layer in range(1, layers + 1):
            setattr(self, f"GCNII_conv{layer}",
                    GCN2Conv(width, layer, alpha, lam, dtype, generator))
        self.GCNII_out = dense(width, num_classes, True, generator)
        self.num_layers = layers

    def convs(self):
        return [getattr(self, f"GCNII_conv{layer}")
                for layer in range(1, self.num_layers + 1)]

    def stack(self, x, senders, receivers, edge_weight, training: bool,
              generator, exchange, edge_mask):
        if exchange is not None:
            raise NotImplementedError(
                "GNN=GCNII: the halo exchange is not supported (GCN2Conv "
                "has no layer code for a halo's extended table)")

        def drop(h):
            return dropout(h, self.dropout_prob, generator,
                           training=training)
        # one normalisation for every layer: the degrees (K2) once
        w = masked_weights(edge_weight, edge_mask)
        dis = gcn_degree_factors(senders, receivers, x.shape[0], w,
                                 x.device)
        h0 = torch.relu(linear(drop(x), self.GCNII_in, self.dtype)).float()
        h = h0
        for conv in self.convs():
            h = torch.relu(conv(drop(h), h0, senders, receivers, w, dis=dis))
        return linear(drop(h), self.GCNII_out, self.dtype).float()


BACKBONES = {"GCN": GNNModel, "GIN": GINModel, "GAT": GATModel,
             "Cheb": ChebModel, "GCNII": GCNIIModel}


def get_model(gnn: str, in_channels: int, hidden_dim: int, num_classes: int,
              dropout_prob: float = 0.3, edge_mlp_type: str = "MLP",
              heads: int = 1, dtype="float32", device="cuda",
              generator=None) -> _Backbone:
    """Backbone factory (reference main.py:98-111): ``gnn`` in GCN, GIN,
    GAT, Cheb, and GCNII at its published widths; ``edge_mlp_type`` in
    MLP, GSAGE, GCN; ``heads`` the first GAT layer's. ``dtype`` is the
    compute dtype of the matmuls (parameters stay float32). Parameters
    are drawn on the CPU from ``generator`` (flax's initialisers), scorer
    first, so one seed gives the same weights on every device, then moved
    to ``device``."""
    if gnn not in BACKBONES:
        raise NotImplementedError(gnn)
    dev = resolve_device(device)
    model = BACKBONES[gnn](in_channels, hidden_dim, num_classes,
                           dropout_prob, edge_mlp_type, heads,
                           torch_dtype(dtype), generator)
    return model.to(dev)

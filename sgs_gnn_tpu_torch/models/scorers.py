"""Edge-probability scorers (port of ``models/scorers.py``): ``EdgeProbMLP``
(a per-node projection), ``EdgeProbSAGE`` (one GraphSAGE layer) and
``EdgeProbGCN`` (two GCN layers), built by ``get_edge_mlp``.

An encoder produces node embeddings h, then a shared score head maps each
edge (u, v) -> sigmoid(fc2(relu(fc1([h_u * h_v || h_u - h_v])))):

    encode(x, prop_senders, prop_receivers) -> h         (N, hidden)
    score_from(h, senders, receivers)       -> probs     (E,)
    score_tiles(h, tile index)              -> probs     (Ep,) tile order
    forward(...) == score_from(encode(...), score edges)

``score_from`` takes one of two routes, as the JAX ``score_from``
(scorers.py:135-171) does:

  * ``receiver_band == 0``: ``ops.score_head_sampled`` (K3 forward, K5
    backward on the card; the JAX fused head);
  * ``receiver_band > 0`` (the receivers are the receiver-sorted edge list
    of ``Graph.receiver_band``): the unfused head, ``gather_rows`` of both
    endpoints (the receiver side's VJP is K7, the sender side's K1) into
    plain torch products: fc1 in its halves, ReLU, layer dropout, fc2,
    sigmoid in f32. ``use_remat`` wraps it in ``torch.utils.checkpoint``,
    the JAX ``jax.checkpoint`` (``--hybrid_checkpoint``).

Under halo (``exchange`` given, ``parallel/halo_train.py``) the head runs
the first route on the extended table ``exchange(h)``: the local rows come
first there, so the local receivers and the extended-space senders both
index it, and the kernels are the sequential route's (the JAX scorer runs
its unfused head on ``exchange(h)[senders]`` and ``h[receivers]``).
The encoders pass ``exchange`` and ``edge_mask`` to their layers.

Under tensor parallelism (``parallel/tensor_parallel.py``) a sharded head
(fc1 column-sharded, fc2 row-sharded) always takes the unfused route: the
fused kernels apply the sigmoid inside the kernel, and fc2's partial
logits must be summed over the model group before b2 and the sigmoid. h
enters it through the group's (a) point (its gradient all-reduced), fc1
gives this rank's block of hidden units, the dropout mask is that block of
the whole (E, K) mask, and fc2's partial logit is reduced in f32. The MLP
and GraphSAGE encoders, whose column-sharded output has no row pair,
all-gather it before the head. ``score_tiles`` and the fused head raise on
a sharded head: the caller builds the graph without a tile index.

``score_tiles`` goes through ``ops.score_head_tiles`` (K6, detached). On
the CPU the ops run their plain versions. fc1 is stored as one
``nn.Linear(2F, K)`` (the JAX tree's concat kernel, transposed) and split
into its product half W1a and difference half W1b at the call, so no (E, 2F)
concat is formed.

Training-mode randomness comes from an explicit ``torch.Generator``: the
encoder's and the unfused head's dropout draw from it (the unfused head's
mask before the head, so ``use_remat``'s recompute reuses it), and the fused
head's dropout seed is one int32 drawn from it on the tensors' device (the
kernels read it there, so no step waits for the card).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (GCNConv, SAGEConv, col_block, col_shard, dense,
                     linear)
from ..ops.dropout import apply_keep, dropout, dropout_keep
from ..ops.edge_gather import gather_rows
from ..ops.score_sampled import score_head_sampled
from ..ops.score_tiles import score_head_tiles


class _ScoreHead(nn.Module):
    """fc1 -> ReLU -> dropout -> fc2 -> sigmoid over [h_u*h_v || h_u-h_v]."""

    def __init__(self, hidden_dim: int, dropout_prob: float, generator=None):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.fc1 = dense(2 * hidden_dim, hidden_dim, True, generator)
        self.fc2 = dense(hidden_dim, 1, True, generator)

    def sharded(self) -> bool:
        return col_shard(self.fc1) is not None

    def _fused_only_unsharded(self, what):
        if self.sharded():
            raise ValueError(
                f"{what}: the head is tensor-parallel; the fused kernels "
                "apply the sigmoid inside the kernel, before fc2's partial "
                "logits could be summed over the model group. Score with "
                "score_from (the unfused route) and build the graph "
                "without a tile index")

    def forward(self, h, senders, receivers, deterministic: bool = True,
                sorted_side: str = "", generator=None):
        self._fused_only_unsharded("the fused score head")
        rate = 0.0 if deterministic else self.dropout_prob
        seed = draw_seed(generator, h.device) if rate > 0.0 else 0
        return score_head_sampled(h, self.fc1.weight.t(), self.fc1.bias,
                                  self.fc2.weight.t(), self.fc2.bias,
                                  senders, receivers, drop_rate=rate,
                                  seed=seed, sorted_side=sorted_side)

    def unfused_keep(self, n_edges: int, device, deterministic: bool = True,
                     generator=None):
        """The layer dropout's kept units of ``unfused`` over ``n_edges``
        edges, drawn from ``generator`` (None: no dropout); a sharded
        head's are its block of the whole mask."""
        if deterministic or self.dropout_prob == 0.0:
            return None
        return dropout_keep((n_edges, self.fc1.weight.shape[0]),
                            self.dropout_prob, generator, device,
                            col_block(self.fc1))

    def unfused(self, hu, hv, keep=None):
        """The JAX ``_ScoreHead.__call__`` on gathered endpoint rows, in
        their dtype: fc1 as W1a (product half) and W1b (difference half),
        ReLU, layer dropout on the units ``keep`` holds (``unfused_keep``),
        fc2 (reduced over the model group when sharded), sigmoid in
        f32."""
        f = hu.shape[1]
        w1 = self.fc1.weight.to(hu.dtype)
        z = (nn.functional.linear(hu * hv, w1[:, :f])
             + nn.functional.linear(hu - hv, w1[:, f:],
                                    self.fc1.bias.to(hu.dtype)))
        z = torch.relu(z)
        if keep is not None:
            z = apply_keep(z, keep, self.dropout_prob)
        logit = linear(z, self.fc2, z.dtype)
        return torch.sigmoid(logit.float()).squeeze(-1)

    def tiles(self, h, tile_ls, tile_lr, tile_su, tile_rv, t: int, bk: int,
              deterministic: bool = True, seed=0):
        self._fused_only_unsharded("score_tiles")
        rate = 0.0 if deterministic else self.dropout_prob
        return score_head_tiles(h, self.fc1.weight.t(), self.fc1.bias,
                                self.fc2.weight.t(), self.fc2.bias, tile_ls,
                                tile_lr, tile_su, tile_rv, t=t, bk=bk,
                                drop_rate=rate, seed=seed)


def draw_seed(generator, device):
    """One dropout seed in [0, 2**31 - 1) as a (1,) int32 tensor on
    ``device``, drawn from ``generator`` (jax.random.randint's range in the
    JAX scorer)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


class _EdgeScorer(nn.Module):
    """Shared part of the scorers: the score head, ``score_from`` with its
    two routes, ``score_tiles`` and ``forward``; a subclass adds its
    encoder after the head, so one generator draws the head first."""

    def __init__(self, hidden_dim: int, dropout_prob: float = 0.2,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_prob = dropout_prob
        self.head = _ScoreHead(hidden_dim, dropout_prob, generator)

    def encode(self, x, prop_senders, prop_receivers,
               deterministic: bool = True, generator=None, exchange=None,
               edge_mask=None):
        raise NotImplementedError

    def score_from(self, h, senders, receivers, deterministic: bool = True,
                   use_remat: bool = False, receiver_band: int = 0,
                   sorted_side: str = "", generator=None, exchange=None):
        """(E,) f32 probabilities of the (senders, receivers) edges; the
        route is chosen by ``receiver_band`` (module docstring).
        ``use_remat`` applies to the unfused route only: the fused head's
        backward recomputes its forward anyway, as in JAX. With
        ``exchange`` the fused head runs on ``exchange(h)``. A sharded head
        takes the unfused route (module docstring)."""
        h = h.to(self.dtype)
        sharded = self.head.sharded()
        if exchange is not None:
            if sharded:
                raise NotImplementedError(
                    "the halo exchange with a tensor-parallel head")
            return self.head(exchange(h), senders, receivers, deterministic,
                             "", generator)
        if receiver_band == 0 and not sharded:
            return self.head(h, senders, receivers, deterministic,
                             sorted_side, generator)
        if sharded:
            h = self.head.fc1.tp.copy_in(h)

        # the dropout mask is drawn before the head, so the checkpoint's
        # recompute reuses it and no generator is rewound (which a CUDA
        # graph capture would refuse)
        keep = self.head.unfused_keep(senders.shape[0], h.device,
                                      deterministic, generator)

        def score(h_, keep_):
            return self.head.unfused(gather_rows(h_, senders),
                                     gather_rows(h_, receivers, receiver_band),
                                     keep_)

        if use_remat:
            return checkpoint(score, h, keep, use_reentrant=False,
                              preserve_rng_state=False)
        return score(h, keep)

    def score_tiles(self, h, tile_ls, tile_lr, tile_su, tile_rv, t: int,
                    bk: int, deterministic: bool = True, seed=0):
        """Detached tile-pair scoring of every slot, in tile order."""
        return self.head.tiles(h.to(self.dtype), tile_ls, tile_lr, tile_su,
                               tile_rv, t, bk, deterministic, seed)

    def forward(self, x, prop_senders, prop_receivers, score_senders,
                score_receivers, deterministic: bool = True,
                use_remat: bool = False, score_receiver_band: int = 0,
                score_sorted_side: str = "", generator=None):
        h = self.encode(x, prop_senders, prop_receivers, deterministic,
                        generator)
        return self.score_from(h, score_senders, score_receivers,
                               deterministic, use_remat, score_receiver_band,
                               score_sorted_side, generator)


def _whole(layer, h, rate, generator, deterministic):
    """The encoder's dropout on ``layer``'s output ``h``; a column-sharded
    one masks this rank's block of the whole mask, then all-gathers the
    features (collective (c)), since no row layer follows."""
    h = dropout(h, rate, generator, training=not deterministic,
                shard=col_block(layer))
    cs = col_shard(layer)
    return h if cs is None else cs.gather(h)


class EdgeProbMLP(_EdgeScorer):
    """MLP scorer (``edge_mlp_type='MLP'``): a per-node projection,
    ReLU and dropout, no propagation; the head gathers the projected rows
    (the JAX scorer's row-wise form)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 dropout_prob: float = 0.2, dtype=torch.float32,
                 generator=None):
        super().__init__(hidden_dim, dropout_prob, dtype, generator)
        self.fcdim = dense(in_channels, hidden_dim, True, generator)

    def encode(self, x, prop_senders, prop_receivers,
               deterministic: bool = True, generator=None, exchange=None,
               edge_mask=None):
        # no propagation: the halo hooks are inert
        h = torch.relu(linear(x, self.fcdim, self.dtype))
        return _whole(self.fcdim, h, self.dropout_prob, generator,
                      deterministic).to(self.dtype)


class EdgeProbSAGE(_EdgeScorer):
    """One GraphSAGE layer + score head (``edge_mlp_type='GSAGE'``). The
    layer is named ``gcn1``, as in JAX: the dual optimizer's 'gcn' filter
    puts it in the GCN and Cheb backbones' group too."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 dropout_prob: float = 0.2, dtype=torch.float32,
                 generator=None):
        super().__init__(hidden_dim, dropout_prob, dtype, generator)
        self.gcn1 = SAGEConv(in_channels, hidden_dim, dtype, generator)

    def encode(self, x, prop_senders, prop_receivers,
               deterministic: bool = True, generator=None, exchange=None,
               edge_mask=None):
        h = self.gcn1(x, prop_senders, prop_receivers, None, exchange,
                      edge_mask)
        return _whole(self.gcn1, torch.relu(h), self.dropout_prob,
                      generator, deterministic).to(self.dtype)


class EdgeProbGCN(_EdgeScorer):
    """2-layer GCN encoder + score head (``edge_mlp_type='GCN'``)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 dropout_prob: float = 0.2, dtype=torch.float32,
                 generator=None):
        # registration order fixes the init order from one generator:
        # head, gcn1, gcn2
        super().__init__(hidden_dim, dropout_prob, dtype, generator)
        self.gcn1 = GCNConv(in_channels, hidden_dim, dtype, generator)
        self.gcn2 = GCNConv(hidden_dim, hidden_dim, dtype, generator)

    def encode(self, x, prop_senders, prop_receivers,
               deterministic: bool = True, generator=None, exchange=None,
               edge_mask=None):
        h = self.gcn1(x, prop_senders, prop_receivers, None, exchange,
                      edge_mask)
        h = dropout(torch.relu(h), self.dropout_prob, generator,
                    training=not deterministic, shard=col_block(self.gcn1))
        h = torch.relu(self.gcn2(h, prop_senders, prop_receivers, None,
                                 exchange, edge_mask))
        return h.to(self.dtype)


SCORERS = {"MLP": EdgeProbMLP, "GSAGE": EdgeProbSAGE, "GCN": EdgeProbGCN}


def get_edge_mlp(in_channels: int, hidden_dim: int, dropout_prob: float,
                 edge_mlp_type: str = "MLP", dtype=torch.float32,
                 generator=None) -> _EdgeScorer:
    """Scorer factory (reference model.py:135-145)."""
    if edge_mlp_type not in SCORERS:
        raise NotImplementedError(edge_mlp_type)
    return SCORERS[edge_mlp_type](in_channels, hidden_dim, dropout_prob,
                                  dtype, generator)

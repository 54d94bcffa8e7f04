"""Graph convolution layers over COO graphs (port of ``models/layers.py``):
``GCNConv``, ``SAGEConv``, ``GATConv``, ``GINConv`` and ``ChebConv``, the
semantics of the PyG layers the reference builds on.

Parameters stay float32; the dense projections run in the compute dtype
(bf16 on the card), degree normalisation and the sparse aggregations
accumulate in float32, with the JAX layers' cast points. Edge weights
follow PyG: GCN and Cheb use them in the normalisation, GIN and GAT
ignore them. Gathers are ``gather_rows`` (VJP: K1, or K2 for an (N,)
table), sums ``ops.scatter`` (K1 for rows, K2 for scalars) or
``ops.segment``; every index stays int32.

A densified subgraph (``ops.dense_graph.DenseEdges``) may be passed in
place of ``senders``, with ``receivers`` None: each layer then aggregates
with (N, N) products, as the JAX layers' ``DenseEdges`` branches do, with
their cast points.

Every layer also takes the JAX layers' two SPMD hooks, so the halo route
(``parallel/halo_train.py``) runs these same modules on one rank's shard:

  * ``exchange``: a callable (N_loc, F) -> (N_ext, F) (or (N_loc,) ->
    (N_ext,)) that keeps the local rows first and appends the boundary
    rows received from the other ranks (``parallel.halo_train.Exchange``).
    With it, sender ids address the extended table and the aggregation is
    a local gather + segment sum (K1, K2) in f32.
  * ``edge_mask``: an (E,) bool; False slots (halo padding) take no part
    in aggregation, normalisation or attention.

With both None the layers compute as before.

Under tensor parallelism (``parallel.shard_params_tp``) a sharded
``nn.Linear`` carries a ``tp`` attribute that ``linear`` reads: a
column-sharded one takes its input through the model group's (a) point
and returns its block of the output features, a row-sharded one sums its
partial product over the group (b) before its bias. The layers' code is
otherwise the same: the aggregations between a column layer and its row
pair work column by column (K1 at F = H/tp), degrees per node (K2); a
column-sharded GCNConv takes its edge weights through (a) as well, since
each block's aggregation and degree scaling adds to their gradient.
``col_shard`` and ``col_block`` name the layers whose output is a column
block.

Initialisers follow flax: ``glorot_uniform`` where the JAX layer names it,
otherwise ``nn.Dense``'s ``lecun_normal`` with a zero bias.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.dense_graph import DenseEdges
from ..ops.edge_gather import gather_rows
from ..ops.gcn_norm import gcn_norm
from ..ops.scatter import scatter_add, segment_sum_scalar
from ..ops.segment import segment_mean, segment_softmax
from ..ops.spmm import spmm

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]
# parameters are float32 whatever torch's default dtype is
PARAM_DTYPE = torch.float32


def glorot_uniform_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``glorot_uniform`` on an (out, in) weight."""
    fan_out, fan_in = weight.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``lecun_normal`` (truncated normal, variance 1/fan_in) on an
    (out, in) weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def dense(in_features: int, features: int, bias: bool = True,
          generator=None) -> nn.Linear:
    """flax ``nn.Dense``'s parameters: lecun_normal weight, zero bias."""
    lin = nn.Linear(in_features, features, bias=bias, dtype=PARAM_DTYPE)
    lecun_normal_(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def glorot_dense(in_features: int, features: int,
                 generator=None) -> nn.Linear:
    """A bias-free projection with a glorot_uniform weight."""
    lin = nn.Linear(in_features, features, bias=False, dtype=PARAM_DTYPE)
    glorot_uniform_(lin.weight, generator)
    return lin


def linear(x, lin: nn.Linear, dtype):
    """``lin`` applied in ``dtype`` (input, weight and bias cast), as flax
    ``nn.Dense(dtype=...)`` computes it. A row-sharded ``lin`` (module
    docstring) sums its partial products in f32, casts the sum to
    ``dtype`` and adds the bias after."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    tp = getattr(lin, "tp", None)
    if tp is not None and not tp.col:
        out = tp.reduce(nn.functional.linear(x.to(dtype),
                                             lin.weight.to(dtype)), dtype)
        return out if bias is None else out + bias
    if tp is not None:
        x = tp.copy_in(x)
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype), bias)


def col_shard(module: nn.Module):
    """The ``parallel.tensor_parallel.Shard`` of a module whose output
    features are this rank's column block, else None."""
    tp = getattr(module, "tp", None)
    return tp if tp is not None and tp.col else None


def col_block(module: nn.Module):
    """(rank, size) of ``col_shard(module)`` (``ops.dropout``'s
    ``shard``), else None."""
    cs = col_shard(module)
    return None if cs is None else cs.cols


class GCNConv(nn.Module):
    """Kipf-Welling GCN layer: D^{-1/2}(A+I)D^{-1/2} X W + b, with PyG
    GCNConv defaults (normalize, add_self_loops, bias).

    The normalisation is node-separable: degrees are weighted in-degrees
    plus one (the self-loop), the two degree factors scale nodes around an
    (un)weighted SpMM, and the self-loop term is added analytically.
    ``backend`` is passed to ``ops.spmm``: "auto" (gather + K1) or "fused"
    (K8; the JAX layer's ``backend="pallas"``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, generator=None,
                 backend: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.backend = backend
        self.lin = glorot_dense(in_features, features, generator)
        self.bias = nn.Parameter(torch.zeros(features, dtype=PARAM_DTYPE))

    def forward(self, x, senders, receivers, edge_weight=None,
                exchange=None, edge_mask=None):
        n = x.shape[0]
        dense = isinstance(senders, DenseEdges)
        cs = col_shard(self)
        if cs is not None and edge_weight is not None:
            # the weights scale every column block: their gradient is the
            # sum of the blocks' (collective (a))
            edge_weight = cs.copy_in(edge_weight)
        if edge_mask is not None:
            mf = edge_mask.float()
            edge_weight = mf if edge_weight is None \
                else edge_weight.float() * mf
        if dense:
            # weighted in-degree: a row sum
            deg = senders.adj.sum(dim=1) + 1.0
        else:
            w_deg = (torch.ones(senders.shape[0], dtype=torch.float32,
                                device=x.device)
                     if edge_weight is None else edge_weight.float())
            deg = segment_sum_scalar(w_deg, receivers, n) + 1.0
        dis = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-32)), 0.0)
        xw = linear(x, self.lin, self.dtype)
        xs = xw * dis[:, None].to(xw.dtype)
        if exchange is not None:
            # halo: the scaled projections of boundary rows arrive by the
            # exchange; senders address the extended table
            agg = spmm(senders, receivers, edge_weight,
                       exchange(xs).float(), n)
        elif dense:
            agg = senders.adj.to(xw.dtype) @ xs
        else:
            agg = spmm(senders, receivers, edge_weight, xs, n,
                       backend=self.backend)
        out = (agg.float() * dis[:, None]
               + (dis * dis)[:, None] * xw.float())
        return out + self.bias


class SAGEConv(nn.Module):
    """GraphSAGE layer, PyG defaults (mean aggregation, root weight):
    W_l mean_{j->i} x_j + b + W_r x_i. The mean is taken of the raw rows
    before the projection, as the JAX layer does: K1 sums x[senders] in
    f32, K2 counts the edges."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.lin_l = dense(in_features, features, True, generator)
        self.lin_r = dense(in_features, features, False, generator)

    def forward(self, x, senders, receivers, edge_weight=None,
                exchange=None, edge_mask=None):
        n = x.shape[0]
        if exchange is not None or edge_mask is not None:
            x_src = exchange(x) if exchange is not None else x
            mf = (torch.ones(senders.shape[0], dtype=torch.float32,
                             device=x.device)
                  if edge_mask is None else edge_mask.float())
            msgs = gather_rows(x_src, senders).float() * mf[:, None]
            cnt = segment_sum_scalar(mf, receivers, n).clamp(min=1.0)
            agg = scatter_add(msgs, receivers, n) / cnt[:, None]
        elif isinstance(senders, DenseEdges):
            cnt = senders.adj.sum(dim=1, keepdim=True).clamp(min=1.0)
            agg = (senders.adj.to(x.dtype) @ x).float() / cnt
        else:
            agg = segment_mean(gather_rows(x, senders), receivers, n)
        out = linear(agg, self.lin_l, self.dtype) \
            + linear(x, self.lin_r, self.dtype)
        return out.float()


class GATConv(nn.Module):
    """Graph attention (GATv1), PyG defaults: heads concatenated or
    averaged, leaky_relu slope 0.2, self-loops added. ``xw`` is projected
    in the compute dtype and kept in f32; the attention logits of the E+N
    edges (self-loops concatenated, int32) are softmaxed per destination
    and head (``segment_softmax``), and the (E+N, H·F) f32 messages are
    summed by K1; over a ``DenseEdges`` the softmax is a masked dense row
    softmax (``_dense``). ``edge_weight`` is ignored."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.heads, self.features = heads, features
        self.concat, self.negative_slope = concat, negative_slope
        self.lin = glorot_dense(in_features, heads * features, generator)
        # glorot_uniform of a (1, H, F) array: fan_in H, fan_out F
        limit = math.sqrt(6.0 / (heads + features))
        self.att_src = nn.Parameter(torch.empty(1, heads, features,
                                                dtype=PARAM_DTYPE))
        self.att_dst = nn.Parameter(torch.empty(1, heads, features,
                                                dtype=PARAM_DTYPE))
        with torch.no_grad():
            for att in (self.att_src, self.att_dst):
                att.uniform_(-limit, limit, generator=generator)
        self.bias = nn.Parameter(torch.zeros(
            heads * features if concat else features, dtype=PARAM_DTYPE))

    def forward(self, x, senders, receivers, edge_weight=None,
                exchange=None, edge_mask=None):
        n, h, f = x.shape[0], self.heads, self.features
        xw = linear(x, self.lin, self.dtype).float()            # (N, H·F)
        xw3 = xw.reshape(n, h, f)
        alpha_src = (xw3 * self.att_src).sum(-1)                 # (N, H)
        alpha_dst = (xw3 * self.att_dst).sum(-1)
        if isinstance(senders, DenseEdges):
            out = self._dense(senders.adj, alpha_src, alpha_dst, xw3)
        else:
            out = self._sparse(senders, receivers, alpha_src, alpha_dst,
                               xw, exchange, edge_mask)
        if not self.concat:
            out = out.reshape(n, h, f).mean(dim=1)
        return out + self.bias

    def _dense(self, adj, alpha_src, alpha_dst, xw3):
        """The attention of a densified subgraph: logits a_src[s] +
        a_dst[r] over (N, N) per head, a row softmax masked to the
        pattern and weighted by the multiplicities ``adj + I`` (duplicate
        edges count apart and the self-loop adds one, as in the segment
        form). Every row holds its self-loop, so no row is all -inf."""
        n, h, f = xw3.shape
        cnt = adj + torch.eye(n, dtype=adj.dtype, device=adj.device)
        lg = nn.functional.leaky_relu(
            alpha_src.t()[:, None, :] + alpha_dst.t()[:, :, None],
            self.negative_slope)                              # (H, N r, N s)
        lg = torch.where(cnt > 0, lg, -torch.inf)
        w = cnt * torch.exp(lg - lg.amax(dim=2, keepdim=True))
        w = w / w.sum(dim=2, keepdim=True).clamp(min=1e-16)
        out = torch.bmm(w.to(xw3.dtype), xw3.transpose(0, 1))  # (H, N, F)
        return out.transpose(0, 1).reshape(n, h * f)

    def _sparse(self, senders, receivers, alpha_src, alpha_dst, xw,
                exchange=None, edge_mask=None):
        """The segment form. Under halo the senders' attention terms and
        projected rows arrive by the exchange and the softmax stays local
        (a node's inbound edges all live on its rank); the self-loops are
        local rows, valid in both index spaces. Masked slots get -inf
        logits."""
        n, h = alpha_src.shape
        f = xw.shape[1] // h
        if h == 1:
            # one head: (N,) tables, so the sums and VJPs are K2's
            alpha_src, alpha_dst = alpha_src[:, 0], alpha_dst[:, 0]
        if exchange is not None:
            alpha_src, xw = exchange(alpha_src), exchange(xw)
        loop = torch.arange(n, dtype=senders.dtype, device=senders.device)
        s = torch.cat([senders, loop])
        r = torch.cat([receivers, loop])
        logits = nn.functional.leaky_relu(
            gather_rows(alpha_src, s) + gather_rows(alpha_dst, r),
            self.negative_slope)
        if edge_mask is not None:
            m = torch.cat([edge_mask, torch.ones(n, dtype=torch.bool,
                                                 device=edge_mask.device)])
            logits = torch.where(m.reshape((-1,) + (1,) * (logits.dim() - 1)),
                                 logits, -torch.inf)
        alpha = segment_softmax(logits, r, n).reshape(-1, h, 1)  # (E', H, 1)
        msgs = gather_rows(xw, s).reshape(-1, h, f) * alpha
        return scatter_add(msgs.reshape(-1, h * f), r, n)


class GINConv(nn.Module):
    """GIN layer with eps = 0: MLP(x_i + sum_{j->i} x_j), the MLP
    Linear-ReLU-Linear in the compute dtype, output f32. The sum is
    ``spmm(backend="auto")``: messages in x's dtype, K1 in f32.
    ``edge_weight`` is ignored."""

    def __init__(self, in_features: int, hidden: int, features: int,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.mlp_lin1 = dense(in_features, hidden, True, generator)
        self.mlp_lin2 = dense(hidden, features, True, generator)

    def forward(self, x, senders, receivers, edge_weight=None,
                exchange=None, edge_mask=None):
        if exchange is not None or edge_mask is not None:
            x_src = exchange(x) if exchange is not None else x
            agg = spmm(senders, receivers,
                       None if edge_mask is None else edge_mask.float(),
                       x_src.float(), x.shape[0])
        elif isinstance(senders, DenseEdges):
            agg = (senders.adj.to(x.dtype) @ x).float()
        else:
            agg = spmm(senders, receivers, None, x, x.shape[0])
        z = x + agg
        z = torch.relu(linear(z, self.mlp_lin1, self.dtype))
        return linear(z, self.mlp_lin2, self.dtype).float()


class ChebConv(nn.Module):
    """Chebyshev spectral convolution, symmetric normalisation, lambda_max
    2: sum_k T_k(L_hat) x Theta_k + b with T_0 = x, T_1 = L_hat x, T_k =
    2 L_hat T_{k-1} - T_{k-2}, L_hat = (2 / lambda_max) (I - A_norm) - I
    and A_norm = D^{-1/2} A D^{-1/2} without self-loops (``gcn_norm``,
    ``spmm``). K = 1 (the backbone's) is the graph-free X Theta_0 + b.
    Theta_0 runs in the compute dtype, Theta_k (k >= 1) in f32, as the JAX
    layer's ``lins_k`` carry no dtype."""

    def __init__(self, in_features: int, features: int, K: int = 1,
                 lambda_max: float = 2.0, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.dtype, self.K, self.lambda_max = dtype, K, lambda_max
        for k in range(K):
            setattr(self, f"lins_{k}",
                    glorot_dense(in_features, features, generator))
        self.bias = nn.Parameter(torch.zeros(features, dtype=PARAM_DTYPE))

    def forward(self, x, senders, receivers, edge_weight=None,
                exchange=None, edge_mask=None):
        out = linear(x, self.lins_0, self.dtype).float()
        if self.K > 1:
            if exchange is not None:
                # K = 1 (the backbone's) is graph-free; the recurrence
                # under halo is not supported, as in JAX
                raise NotImplementedError(
                    "halo exchange supports ChebConv K=1 only")
            n = x.shape[0]
            if isinstance(senders, DenseEdges):
                # D^-1/2 A D^-1/2 densely: rows and columns scaled
                adj = senders.adj
                deg = adj.sum(dim=1)
                dis = torch.where(deg > 0,
                                  torch.rsqrt(deg.clamp(min=1e-32)),
                                  0.0)[:, None]

                def a_norm(v):
                    return dis * (adj @ (dis * v))
            else:
                s, r, w = gcn_norm(senders, receivers, edge_weight, n,
                                   add_loops=False)

                def a_norm(v):
                    return spmm(s, r, w, v, n)

            def l_hat(v):
                return (2.0 / self.lambda_max) * (v - a_norm(v)) - v

            tx_prev, tx = x, l_hat(x)
            out = out + linear(tx, self.lins_1, torch.float32)
            for k in range(2, self.K):
                tx_prev, tx = tx, 2.0 * l_hat(tx) - tx_prev
                out = out + linear(tx, getattr(self, f"lins_{k}"),
                                   torch.float32)
        return out + self.bias

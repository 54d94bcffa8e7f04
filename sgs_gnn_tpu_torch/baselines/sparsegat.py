"""SparseGAT baseline: L0-regularised graph attention (port of
``baselines/sparsegat.py``; reference
Notebooks/1KDDSparseGAToptimized.ipynb: ``l0_train``, ``GraphAttention``,
``get_sparsegat_edge_weights``).

Per-edge hard-concrete gates multiply the attention coefficients, and an
L0 penalty (the expected number of open gates) pushes edges to exactly
zero: a learned sparsifier. Hard-concrete gate (Louizos et al. 2018):

    u ~ U(0,1);  s = sigmoid((log u - log(1-u) + log_alpha) / beta)
    s_bar = s * (zeta - gamma) + gamma;  z = clip(s_bar, 0, 1)
    L0 = sigmoid(log_alpha - beta * log(-gamma / zeta))

Each layer's attention softmax is ``ops.segment.segment_softmax`` (K2 for
the denominators), the gathers are ``gather_rows`` (VJPs K2 for the (N,)
attention terms, K1 for the rows) and the message sum is
``ops.segment.segment_sum`` (K1), all in f32. Randomness (the gates' draws
when not ``deterministic``, the layer dropout) comes from the caller's
``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.device import resolve_device, torch_dtype
from ..models.layers import PARAM_DTYPE, dense, linear
from ..ops.dropout import dropout
from ..ops.edge_gather import gather_rows
from ..ops.segment import segment_softmax, segment_sum

_GAMMA, _ZETA, _BETA = -0.1, 1.1, 0.66


def hard_concrete(generator, log_alpha, deterministic: bool):
    """The gates z in [0, 1] of ``log_alpha``: their mean value when
    ``deterministic``, else one draw from ``generator``."""
    if deterministic:
        s = torch.sigmoid(log_alpha)
    else:
        lo, hi = 1e-6, 1.0 - 1e-6
        u = lo + (hi - lo) * torch.rand(log_alpha.shape, generator=generator,
                                        device=log_alpha.device)
        s = torch.sigmoid((torch.log(u) - torch.log1p(-u) + log_alpha)
                          / _BETA)
    return torch.clamp(s * (_ZETA - _GAMMA) + _GAMMA, 0.0, 1.0)


def l0_penalty(log_alpha):
    """Expected number of non-zero gates (the l0_train loss term)."""
    return torch.sigmoid(log_alpha - _BETA * math.log(-_GAMMA / _ZETA)).sum()


def _glorot_row(features: int, generator):
    """flax ``glorot_uniform`` of a (1, features) array."""
    limit = math.sqrt(6.0 / (1 + features))
    p = nn.Parameter(torch.empty(1, features, dtype=PARAM_DTYPE))
    with torch.no_grad():
        p.uniform_(-limit, limit, generator=generator)
    return p


class SparseGAT(nn.Module):
    """2-layer GAT with per-edge L0 gates shared across the layers. The
    gates' ``log_alpha`` has one entry per edge of the graph it is built
    for (``num_edges``). Parameter names are flax's (``log_alpha``,
    ``gat{1,2}_lin``, ``gat{1,2}_att_src``, ``gat{1,2}_att_dst``), drawn on
    the CPU from ``generator`` and moved to ``device``; ``dtype`` is the
    compute dtype of the projections."""

    def __init__(self, in_channels: int, num_edges: int, hidden_dim: int,
                 num_classes: int, dropout_prob: float = 0.3,
                 dtype="float32", device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_prob = dropout_prob
        self.dtype = torch_dtype(dtype)
        self.log_alpha = nn.Parameter(
            0.01 * torch.randn(num_edges, generator=generator,
                               dtype=PARAM_DTYPE))
        for name, fin, fout in (("gat1", in_channels, hidden_dim),
                                ("gat2", hidden_dim, num_classes)):
            setattr(self, f"{name}_lin", dense(fin, fout, False, generator))
            setattr(self, f"{name}_att_src", _glorot_row(fout, generator))
            setattr(self, f"{name}_att_dst", _glorot_row(fout, generator))
        self.to(dev)

    def _gat_layer(self, name, x_in, senders, receivers, z):
        n = x_in.shape[0]
        xw = linear(x_in, getattr(self, f"{name}_lin"), self.dtype).float()
        att_s = (xw * getattr(self, f"{name}_att_src")).sum(1)
        att_d = (xw * getattr(self, f"{name}_att_dst")).sum(1)
        logits = nn.functional.leaky_relu(
            gather_rows(att_s, senders) + gather_rows(att_d, receivers), 0.2)
        alpha = segment_softmax(logits, receivers, n) * z     # gated
        msgs = gather_rows(xw, senders) * alpha[:, None]
        return segment_sum(msgs, receivers, n)

    def forward(self, x, senders, receivers, generator=None,
                deterministic: bool = True):
        """(logits (N, num_classes), L0 penalty): JAX's argument order,
        ``generator`` in place of ``key``."""
        z = hard_concrete(generator, self.log_alpha, deterministic)
        h = torch.relu(self._gat_layer("gat1", x, senders, receivers, z))
        h = dropout(h, self.dropout_prob, generator,
                    training=not deterministic)
        out = self._gat_layer("gat2", h, senders, receivers, z)
        return out, l0_penalty(self.log_alpha)

    @staticmethod
    def edge_weights(state_dict):
        """The deterministic gate values of a state dict (or the flax tree's
        parameter dict moved by ``params_from_jax``): the learned
        sparsification pattern (get_sparsegat_edge_weights)."""
        la = state_dict["log_alpha"]
        s = torch.sigmoid(la) * (_ZETA - _GAMMA) + _GAMMA
        return torch.clamp(s, 0.0, 1.0)

"""Graph convolution layers over COO graphs (port of ``models/layers.py``;
this slice carries ``GCNConv``).

Parameters stay float32; the dense projection runs in the compute dtype
(bf16 on the card), degree normalisation and the sparse aggregation
accumulate in float32, with the JAX layer's cast points.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.scatter import segment_sum_scalar
from ..ops.spmm import spmm


def glorot_uniform_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``glorot_uniform`` on an (out, in) weight."""
    fan_out, fan_in = weight.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


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
        self.lin = nn.Linear(in_features, features, bias=False)
        glorot_uniform_(self.lin.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, senders, receivers, edge_weight=None):
        n = x.shape[0]
        w_deg = (torch.ones(senders.shape[0], dtype=torch.float32,
                            device=x.device)
                 if edge_weight is None else edge_weight.float())
        deg = segment_sum_scalar(w_deg, receivers, n) + 1.0
        dis = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-32)), 0.0)
        xw = nn.functional.linear(x.to(self.dtype),
                                  self.lin.weight.to(self.dtype))
        xs = xw * dis[:, None].to(xw.dtype)
        agg = spmm(senders, receivers, edge_weight, xs, n,
                   backend=self.backend)
        out = (agg.float() * dis[:, None]
               + (dis * dis)[:, None] * xw.float())
        return out + self.bias

"""GCN symmetric normalisation with explicit edges (port of
``ops/gcn_norm.py``): PyG's ``gcn_norm`` semantics, D^{-1/2} (A [+ I])
D^{-1/2} with d the weighted in-degree.

``GCNConv`` folds the normalisation into per-node scalings and never forms
these arrays; ``ChebConv`` (K > 1) takes the explicit form without
self-loops. Degrees are K2 sums (``segment_sum_scalar``), and the per-edge
gathers of d^{-1/2} are ``gather_rows`` of an (N,) table, whose VJP is K2
too. Zero-degree nodes get coefficient 0 (PyG's
``deg_inv_sqrt.masked_fill_(inf, 0)``).
"""
from __future__ import annotations

import torch

from .edge_gather import gather_rows
from .scatter import segment_sum_scalar


def _ones(senders):
    return torch.ones(senders.shape[0], dtype=torch.float32,
                      device=senders.device)


def _inv_sqrt(deg):
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-32)), 0.0)


def add_self_loops(senders, receivers, weights, num_nodes: int,
                   fill_value: float = 1.0):
    """The edge list with one (n, n) edge of weight ``fill_value`` per node
    appended; indices keep their dtype (int32)."""
    loop = torch.arange(num_nodes, dtype=senders.dtype, device=senders.device)
    loop_w = torch.full((num_nodes,), fill_value, dtype=weights.dtype,
                        device=weights.device)
    return (torch.cat([senders, loop]), torch.cat([receivers, loop]),
            torch.cat([weights, loop_w]))


def gcn_norm_terms(senders, receivers, weights, num_nodes: int,
                   fill_value: float = 1.0):
    """The normalisation without self-loop edges: ``(norm, loop_coef)``
    with norm[e] = d^{-1/2}[s_e] w_e d^{-1/2}[r_e] and loop_coef[n] =
    d^{-1/2}[n]^2 fill_value, d = weighted in-degree + fill_value."""
    if weights is None:
        weights = _ones(senders)
    dis = _inv_sqrt(segment_sum_scalar(weights, receivers, num_nodes)
                    + fill_value)
    norm = gather_rows(dis, senders) * weights * gather_rows(dis, receivers)
    return norm, dis * dis * fill_value


def gcn_norm(senders, receivers, weights, num_nodes: int,
             add_loops: bool = True):
    """(senders', receivers', norm') with the symmetric normalisation;
    ``weights=None`` is unweighted (ones)."""
    if weights is None:
        weights = _ones(senders)
    if add_loops:
        senders, receivers, weights = add_self_loops(
            senders, receivers, weights, num_nodes)
    dis = _inv_sqrt(segment_sum_scalar(weights, receivers, num_nodes))
    norm = gather_rows(dis, senders) * weights * gather_rows(dis, receivers)
    return senders, receivers, norm

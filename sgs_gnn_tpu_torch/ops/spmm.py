"""COO SpMM: y[r] = sum over edges e with receivers[e]==r of
w[e] * x[senders[e]]  (port of ``ops/spmm.py``, the XLA route).

Messages are formed in ``x.dtype`` (bf16 halves the traffic), summed in
float32 by ``scatter_add`` and cast back to ``x.dtype``, as the JAX
``_spmm_fwd_impl`` and ``_spmm_unweighted`` do. ``weights=None`` is the
plain adjacency SpMM (GCN folds its normalisation into per-node scalings).

Built from the differentiable ``gather_rows`` and ``scatter_add``, so
autograd gives the JAX custom VJP (``ops/spmm.py:149-175``): dx is the
transpose SpMM (gather of the cotangent at the receivers, times w, then K1
over the senders) and dw the SDDMM ``<x[senders], g[receivers]>``, with the
products in ``x.dtype`` as there.
"""
from __future__ import annotations

from .edge_gather import gather_rows
from .scatter import scatter_add


def spmm(senders, receivers, weights, x, num_nodes: int):
    """(N, F) = A_w @ x over the (senders, receivers) edge list."""
    msgs = gather_rows(x, senders)
    if weights is not None:
        msgs = msgs * weights[:, None].to(x.dtype)
    return scatter_add(msgs, receivers, num_nodes).to(x.dtype)

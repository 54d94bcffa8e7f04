"""COO SpMM: y[r] = sum over edges e with receivers[e]==r of
w[e] * x[senders[e]]  (port of ``ops/spmm.py`` and ``ops/spmm_pallas.py``).

Two routes, chosen by ``backend`` as in the JAX ``spmm``:

``"auto"`` (the JAX XLA route, spmm.py:97-106, 121-123): messages are
formed in ``x.dtype`` (bf16 halves the traffic), summed in float32 by
``scatter_add`` and cast back to ``x.dtype``, as the JAX ``_spmm_fwd_impl``
and ``_spmm_unweighted`` do. ``weights=None`` is the plain adjacency SpMM
(GCN folds its normalisation into per-node scalings). Built from the
differentiable ``gather_rows`` and ``scatter_add``, so autograd gives the
JAX custom VJP (spmm.py:149-175): dx is the transpose SpMM (gather of the
cotangent at the receivers, times w, then K1 over the senders) and dw the
SDDMM ``<x[senders], g[receivers]>``, with the products in ``x.dtype`` as
there.

``"fused"`` (the JAX ``backend="pallas"``, spmm.py:116-120, over
``spmm_pallas.py``): one pass with no (E, F) message matrix in device
memory, K8 on a card (``csrc/spmm.cu``). ``weights=None`` becomes ones.
The weight is cast to ``x.dtype``, each product ``w * x[s]`` is formed in
f32 (not rounded to bf16 as the "auto" route rounds it), the sum is f32 and
the result is cast to ``x.dtype``, as ``_spmm_pallas_impl`` computes. Its
VJP mirrors ``_spmm_pallas_bwd`` (spmm_pallas.py:128-135): dx is K8 on the
reversed edges with ``g`` cast to ``x.dtype``, dw the SDDMM in plain
torch, as JAX leaves it to XLA. The JAX route's fall-back to XLA when x and
the accumulator overflow VMEM (``fits_vmem``) is a TPU memory rule and is
not copied.
"""
from __future__ import annotations

import torch

from . import _build
from .edge_gather import gather_rows
from .scatter import rows_at, scatter_add, scatter_add_plain

BACKENDS = ("auto", "fused")


def spmm(senders, receivers, weights, x, num_nodes: int,
         backend: str = "auto"):
    """(N, F) = A_w @ x over the (senders, receivers) edge list."""
    if backend == "fused":
        if weights is None:
            weights = torch.ones(senders.shape[0], dtype=torch.float32,
                                 device=x.device)
        return _SpmmFused.apply(senders, receivers, weights, x, num_nodes)
    if backend != "auto":
        raise ValueError(f"spmm: backend={backend!r} not in {BACKENDS}")
    msgs = gather_rows(x, senders)
    if weights is not None:
        msgs = msgs * weights[:, None].to(x.dtype)
    return scatter_add(msgs, receivers, num_nodes).to(x.dtype)


def spmm_fused_plain(senders, receivers, weights, x, num_nodes: int):
    """Plain version of K8: f32 products of the ``x.dtype``-rounded weight
    and x rows, ``index_add_`` in f32; (N, F) float32. Edges with an
    endpoint outside [0, N) contribute nothing."""
    w = weights.to(x.dtype).float()
    msgs = rows_at(x, senders, num_nodes).float() * w[:, None]
    return scatter_add_plain(msgs, receivers, num_nodes)


def _spmm_fused(senders, receivers, weights, x, num_nodes: int):
    if x.device.type == "cpu":
        return spmm_fused_plain(senders, receivers, weights, x, num_nodes)
    _build.check_cuda("spmm_fused", senders, receivers, weights, x)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"spmm_fused: x dtype {x.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"spmm_fused: weights dtype {weights.dtype}, want "
                        "float32")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError("spmm_fused: senders and receivers must be int32")
    if x.shape[0] != num_nodes:
        raise ValueError(f"spmm_fused: x has {x.shape[0]} rows, "
                         f"num_nodes={num_nodes}")
    e, f = senders.shape[0], x.shape[1]
    out = torch.zeros((num_nodes, f), dtype=torch.float32, device=x.device)
    if e == 0 or f == 0 or num_nodes == 0:
        return out
    _build.call("spmm_fused", "sgs_spmm_fused", x.device, senders.data_ptr(),
                receivers.data_ptr(), weights.data_ptr(), x.data_ptr(),
                int(x.dtype == torch.bfloat16), out.data_ptr(), e,
                num_nodes, f)
    return out


class _SpmmFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, senders, receivers, weights, x, num_nodes):
        if senders.shape != receivers.shape or weights.shape != senders.shape:
            raise ValueError("spmm: senders, receivers and weights must be "
                             "(E,)")
        ctx.weights_dtype = weights.dtype
        senders, receivers = senders.contiguous(), receivers.contiguous()
        weights, x = weights.float().contiguous(), x.contiguous()
        ctx.save_for_backward(senders, receivers, weights, x)
        ctx.num_nodes = num_nodes
        return _spmm_fused(senders, receivers, weights, x,
                           num_nodes).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        senders, receivers, weights, x = ctx.saved_tensors
        n = ctx.num_nodes
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[3]:
            dx = _spmm_fused(receivers, senders, weights, g, n).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = torch.sum(rows_at(x, senders, n) * rows_at(g, receivers, n),
                           dim=-1).to(ctx.weights_dtype)
        return None, None, dw, dx, None

"""Row gather with a segment-sum backward (port of ``ops/edge_gather.py``).

``gather_rows(table, idx) == table[idx]``; its VJP accumulates the row
cotangents back into the table, ``d table = scatter_add(d out, idx)``,
which on a card is K1 (``ops/scatter.py``). Cotangents stay in their own
type, f32 for f32 tables, as the JAX package's CPU path keeps them
(``segment_sum`` of f32 rows); the JAX TPU path's truncation of f32
cotangents to bf16 before its one-hot MXU scatter (edge_gather.py:56-57)
was an MXU operand choice and is not copied.
"""
from __future__ import annotations

import torch

from .scatter import scatter_add


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        dt = scatter_add(g.contiguous(), idx, ctx.num_rows)
        return dt.to(ctx.table_dtype), None


def gather_rows(table, idx):
    """table[idx] for an (E,) int32 or int64 index; differentiable in
    ``table``."""
    return _GatherRows.apply(table, idx)

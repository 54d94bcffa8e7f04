"""Row gather with a segment-sum backward (port of ``ops/edge_gather.py``).

``gather_rows(table, idx, sorted_band) == table[idx]``; its VJP accumulates
the row cotangents back into the table, ``d table = scatter_add(d out,
idx)``. On a card that is K1 (``ops/scatter.py``; K2,
``segment_sum_scalar``, for an (N,) table), or K7
(``scatter_add_sorted``) when the caller declares ``idx`` non-decreasing
with the narrow-band bound ``sorted_band`` (``Graph.receiver_band``), as
the JAX op routes it (edge_gather.py:47-64). A band below
``required_band(idx)`` drops contributions, as on the TPU, so pass only
the band computed from the same static index array. Cotangents stay in
their own type, f32 for f32 tables, as the JAX package's CPU path keeps
them (``segment_sum`` of f32 rows); the JAX TPU path's truncation of f32
cotangents to bf16 before its one-hot MXU scatter (edge_gather.py:56-57)
was an MXU operand choice and is not copied.
"""
from __future__ import annotations

import torch

from .scatter import scatter_add, scatter_add_sorted, segment_sum_scalar


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, sorted_band):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.sorted_band = sorted_band
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        if g.dim() == 1:
            dt = segment_sum_scalar(g.float().contiguous(), idx,
                                    ctx.num_rows)
        elif ctx.sorted_band > 0:
            dt = scatter_add_sorted(g.contiguous(), idx, ctx.num_rows,
                                    ctx.sorted_band)
        else:
            dt = scatter_add(g.contiguous(), idx, ctx.num_rows)
        return dt.to(ctx.table_dtype), None, None


def gather_rows(table, idx, sorted_band: int = 0):
    """table[idx] for an (N, F) or (N,) table and an (E,) int32 or int64
    index; differentiable in ``table``. ``sorted_band`` > 0 declares ``idx``
    non-decreasing with that band (see the module docstring; (N, F) tables
    only)."""
    if table.dim() == 1 and sorted_band:
        raise ValueError("gather_rows: sorted_band needs an (N, F) table")
    return _GatherRows.apply(table, idx, int(sorted_band))

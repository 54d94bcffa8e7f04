"""Segment reductions over COO edge lists (port of ``ops/segment.py``).

The JAX package computes these with ``jax.ops.segment_*`` (XLA). Here the
sums run on the hand-written kernels: rows ((E, F) data) through
``scatter_add`` (K1), scalars ((E,) data) through ``segment_sum_scalar``
(K2); both sum in float32. The max is ``Tensor.scatter_reduce`` with
"amax". Segment ids are int32, as the kernels take them; an (E, H, F)
input is summed as (E, H·F) rows.
"""
from __future__ import annotations

import torch

from .edge_gather import gather_rows
from .scatter import scatter_add, segment_sum_scalar


def _sum_f32(data, segment_ids, num_segments: int):
    """The f32 segment sum of (E,) or (E, ...) data: K2 or K1."""
    if data.dim() == 1:
        return segment_sum_scalar(data.float(), segment_ids, num_segments)
    rows = scatter_add(data.reshape(data.shape[0], -1), segment_ids,
                       num_segments)
    return rows.reshape((num_segments,) + data.shape[1:])


def segment_sum(data, segment_ids, num_segments: int):
    """(num_segments, ...) sums of ``data`` by ``segment_ids``, in
    ``data.dtype`` (summed in f32)."""
    return _sum_f32(data, segment_ids, num_segments).to(data.dtype)


def segment_mean(data, segment_ids, num_segments: int):
    """The segment sum divided by the segment's item count clamped at 1
    (an empty segment gives 0): K1 (or K2) over the data, K2 over ones;
    in ``data.dtype``."""
    s = _sum_f32(data, segment_ids, num_segments)
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32,
                      device=data.device)
    cnt = segment_sum_scalar(ones, segment_ids, num_segments).clamp(min=1.0)
    return (s / cnt.reshape((-1,) + (1,) * (data.dim() - 1))).to(data.dtype)


def segment_max(data, segment_ids, num_segments: int):
    """(num_segments, ...) maxima of ``data`` by ``segment_ids``; an empty
    segment gives -inf (``jax.ops.segment_max``'s identity)."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = torch.full((num_segments,) + data.shape[1:], float("-inf"),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=False)


def segment_softmax(logits, segment_ids, num_segments: int):
    """Softmax of (E,) or (E, H) ``logits`` over the edges of each
    destination segment (per head column), with the JAX function's rules:
    a non-finite segment max counts as 0, and the denominator is clamped at
    1e-16. The denominator is a K2 sum for (E,) logits and a K1 sum with
    F=H for (E, H); the gathers back to the edges are ``gather_rows``, so
    their VJPs are K2 / K1 as well.

    The segment max is taken without gradient. Softmax is invariant to a
    shift that is constant within a segment, so the gradient through the
    max is zero and ``jax.grad`` of the JAX function (which differentiates
    through it) agrees up to rounding."""
    with torch.no_grad():
        seg_max = segment_max(logits, segment_ids, num_segments)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        shift = seg_max[segment_ids.long()]
    exp = torch.exp(logits - shift)
    denom = _sum_f32(exp, segment_ids, num_segments)
    return exp / gather_rows(denom, segment_ids).clamp(min=1e-16)

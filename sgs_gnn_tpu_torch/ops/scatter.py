"""Segment sums over edge ids: the port of ``ops/scatter_pallas.py``.

Two kernels, each with its plain PyTorch version beside it. The wrapper
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.

``scatter_add(vals, ids, n)``: ``out[n] = sum_{ids[i]=n} vals[i]``, (E, F)
bf16 or f32 -> (N, F) f32. Replaces ``scatter_pallas.py:_scatter_kernel``
(behind ``scatter_add_pallas``), which turned the scatter into one-hot
matmuls because the TPU has no fast dynamic scatter. On the H100 the
kernel (``csrc/scatter.cu``) scatters directly with f32 atomics. It is
bound by bytes (E*F*itemsize + 4E + 4NF: ~0.16 ms for E=1M, F=256 bf16 at
3.35 TB/s); the risk is atomic contention on a few thousand rows, which the
kernel cuts by merging runs of equal ids (receiver-sorted edge lists) in
registers before one atomic per run.

``segment_sum_scalar(w, ids, n)``: ``deg[n] = sum_{ids[i]=n} w[i]``, (E,)
f32 -> (N,) f32. Replaces ``scatter_pallas.py:_scalar_kernel`` (behind
``_segment_sum_scalar_pallas``), which rounds w to bf16; the port keeps
f32, as the JAX package's own CPU path does. Bound by bytes (8E: ~2.4 us
at E=1M). The kernel (``csrc/segment_sum.cu``) builds a per-block
histogram in shared memory and flushes it with one global atomic per
touched node; for N too large for shared memory it uses global atomics.

Ids outside [0, N) are dropped, as ``jax.ops.segment_sum`` drops them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build


def _round_up(x, m):
    return (x + m - 1) // m * m


def required_band(ids_sorted, block: int = 1024, align: int = 8) -> int:
    """Max segment span of any ``block``-item window of the sorted id array,
    measured from the window's ``align``-aligned origin; host-side, static
    per graph. Returns a multiple of ``align``. (Own copy of
    ``scatter_pallas.required_band``, which ``Graph.receiver_band`` records.)
    """
    ids_sorted = np.asarray(ids_sorted)
    e = ids_sorted.shape[0]
    if e == 0:
        return align
    e_pad = _round_up(e, block)
    ids_p = np.concatenate(
        [ids_sorted, np.full(e_pad - e, ids_sorted[-1], ids_sorted.dtype)])
    firsts = ids_p[::block] // align * align
    lasts = ids_p[block - 1::block]
    span = int((lasts - firsts).max()) + 1
    return _round_up(max(span, align), align)


def _in_range(ids, num_segments):
    return (ids >= 0) & (ids < num_segments)


def scatter_add_plain(vals, ids, num_segments: int):
    """Plain version: ``index_add_`` in f32."""
    keep = _in_range(ids, num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, ids[keep].long(), vals[keep].float())


def scatter_add(vals, ids, num_segments: int):
    """(E, F) rows summed by ``ids`` into (num_segments, F) float32."""
    if vals.dim() != 2 or ids.shape != (vals.shape[0],):
        raise ValueError(f"scatter_add: vals {tuple(vals.shape)} and ids "
                         f"{tuple(ids.shape)} do not match")
    if vals.device.type == "cpu":
        return scatter_add_plain(vals, ids, num_segments)
    _build.check_cuda("scatter_add", vals, ids)
    if vals.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scatter_add: vals dtype {vals.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"scatter_add: ids dtype {ids.dtype}, want int32")
    e, f = vals.shape
    out = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=vals.device)
    if e == 0 or f == 0 or num_segments == 0:
        return out
    _build.call("scatter_add", "sgs_scatter_add", vals.device,
                vals.data_ptr(), int(vals.dtype == torch.bfloat16),
                ids.data_ptr(), out.data_ptr(), e, f, num_segments)
    return out


def segment_sum_scalar_plain(w, ids, num_segments: int):
    """Plain version: ``index_add_`` in f32."""
    keep = _in_range(ids, num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=w.device)
    return out.index_add_(0, ids[keep].long(), w[keep].float())


def segment_sum_scalar(w, ids, num_segments: int):
    """(E,) weights summed by ``ids`` into (num_segments,) float32."""
    if w.dim() != 1 or ids.shape != w.shape:
        raise ValueError(f"segment_sum_scalar: w {tuple(w.shape)} and ids "
                         f"{tuple(ids.shape)} do not match")
    if w.device.type == "cpu":
        return segment_sum_scalar_plain(w, ids, num_segments)
    _build.check_cuda("segment_sum_scalar", w, ids)
    if w.dtype != torch.float32:
        raise TypeError(f"segment_sum_scalar: w dtype {w.dtype}, want float32")
    if ids.dtype != torch.int32:
        raise TypeError(f"segment_sum_scalar: ids dtype {ids.dtype}, "
                        "want int32")
    out = torch.zeros(num_segments, dtype=torch.float32, device=w.device)
    if w.shape[0] == 0 or num_segments == 0:
        return out
    _build.call("segment_sum_scalar", "sgs_segment_sum_scalar", w.device,
                w.data_ptr(), ids.data_ptr(), out.data_ptr(), w.shape[0],
                num_segments)
    return out

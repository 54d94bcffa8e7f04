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

``scatter_add_sorted(vals, ids_sorted, n, band)``: ``scatter_add`` over
non-decreasing ids with the TPU kernel's band rule. Replaces
``scatter_pallas.py:_make_sorted_kernel`` (behind
``scatter_add_sorted_pallas``), which built its one-hot panel over a
``band``-row slice of the output per 1024-item window only. The port keeps
that kernel's function, including what it drops (``sorted_band_keep``): with
``band >= required_band(ids, block)`` it is the exact segment sum. The
kernel (``csrc/scatter_sorted.cu``) is a segmented reduction: each warp
sums the runs of equal ids in its item range in registers and stores a run
that lies wholly inside its range straight into the zeroed output; only
runs that cross a range boundary take f32 atomics. Bound by bytes, like
``scatter_add``.

Ids outside [0, N) are dropped, as ``jax.ops.segment_sum`` drops them.

``scatter_add`` and ``segment_sum_scalar`` are differentiable in their
values through ``autograd.Function``s:
the VJP of a segment sum is a gather of the cotangent at the ids
(``scatter_pallas.py:332-333``), zero for dropped ids. The gather is a plain
row index on either device: it is no TPU kernel's counterpart.
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


def rows_at(g, ids, num_segments: int):
    """``g[ids]`` with zero rows where an id is outside [0, num_segments):
    the VJP of both segment sums, and how the head kernels read such ids."""
    keep = _in_range(ids, num_segments)
    rows = g[ids.clamp(0, max(num_segments - 1, 0)).long()]
    return torch.where(keep.reshape((-1,) + (1,) * (g.dim() - 1)), rows, 0)


class _ScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        ctx.vals_dtype = vals.dtype
        return _scatter_add(vals, ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return rows_at(g, ids, ctx.num_segments).to(ctx.vals_dtype), None, \
            None


class _SegmentSumScalar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        ctx.w_dtype = w.dtype
        return _segment_sum_scalar(w, ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return rows_at(g, ids, ctx.num_segments).to(ctx.w_dtype), None, None


def scatter_add(vals, ids, num_segments: int):
    """(E, F) rows summed by ``ids`` into (num_segments, F) float32;
    differentiable in ``vals``."""
    if vals.dim() != 2 or ids.shape != (vals.shape[0],):
        raise ValueError(f"scatter_add: vals {tuple(vals.shape)} and ids "
                         f"{tuple(ids.shape)} do not match")
    return _ScatterAdd.apply(vals, ids, num_segments)


def _scatter_add(vals, ids, num_segments: int):
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


def _band_geometry(num_segments: int, band: int, block: int):
    """(band rounded up to a multiple of 8, n_pad) as the TPU wrapper
    computes them (scatter_pallas.py:165-166)."""
    if band <= 0 or block <= 0:
        raise ValueError(f"band={band} and block={block} must be > 0")
    band = min(_round_up(band, 8), 1 << 30)
    return band, _round_up(max(num_segments, 8), 8) + band


def sorted_band_keep(ids_sorted, num_segments: int, band: int,
                     block: int = 1024):
    """(E,) bool: the items that ``scatter_add_sorted_pallas`` adds. The
    band is rounded up to a multiple of 8; window w (items [w*block,
    (w+1)*block)) writes rows [start_w, start_w + band) with ``start_w =
    min(ids[w*block] // 8 * 8, n_pad - band)`` and ``n_pad = round_up(max(N,
    8), 8) + band`` (scatter_pallas.py:165-177); rows >= N are cut off.
    Negative ids are dropped too (the TPU's band slice would start outside
    its output)."""
    band, n_pad = _band_geometry(num_segments, band, block)
    ids = ids_sorted.long()
    starts = torch.clamp(torch.div(ids[::block], 8, rounding_mode="floor") * 8,
                         max=n_pad - band)
    window = torch.arange(ids.shape[0], device=ids.device) // block
    lid = ids - starts[window]
    return _in_range(ids, num_segments) & (lid >= 0) & (lid < band)


def scatter_add_sorted_plain(vals, ids_sorted, num_segments: int, band: int,
                             block: int = 1024):
    """Plain version: the band rule of ``sorted_band_keep``, then
    ``index_add_`` in f32."""
    keep = sorted_band_keep(ids_sorted, num_segments, band, block)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, ids_sorted[keep].long(), vals[keep].float())


def scatter_add_sorted(vals, ids_sorted, num_segments: int, band: int,
                       block: int = 1024):
    """(E, F) bf16/f32 rows summed by non-decreasing ``ids_sorted`` into
    (num_segments, F) float32, dropping what the TPU kernel drops for this
    ``band`` and ``block`` (``sorted_band_keep``). Not differentiable: it is
    the VJP of ``gather_rows(..., sorted_band)``."""
    if vals.dim() != 2 or ids_sorted.shape != (vals.shape[0],):
        raise ValueError(f"scatter_add_sorted: vals {tuple(vals.shape)} and "
                         f"ids {tuple(ids_sorted.shape)} do not match")
    if vals.device.type == "cpu":
        return scatter_add_sorted_plain(vals, ids_sorted, num_segments, band,
                                        block)
    band8, n_pad = _band_geometry(num_segments, band, block)
    _build.check_cuda("scatter_add_sorted", vals, ids_sorted)
    if vals.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scatter_add_sorted: vals dtype {vals.dtype}")
    if ids_sorted.dtype != torch.int32:
        raise TypeError(f"scatter_add_sorted: ids dtype {ids_sorted.dtype}, "
                        "want int32")
    e, f = vals.shape
    out = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=vals.device)
    if e == 0 or f == 0 or num_segments == 0:
        return out
    _build.call("scatter_add_sorted", "sgs_scatter_add_sorted", vals.device,
                vals.data_ptr(), int(vals.dtype == torch.bfloat16),
                ids_sorted.data_ptr(), out.data_ptr(), e, f, num_segments,
                band8, n_pad, block)
    return out


def segment_sum_scalar_plain(w, ids, num_segments: int):
    """Plain version: ``index_add_`` in f32."""
    keep = _in_range(ids, num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=w.device)
    return out.index_add_(0, ids[keep].long(), w[keep].float())


def segment_sum_scalar(w, ids, num_segments: int):
    """(E,) weights summed by ``ids`` into (num_segments,) float32;
    differentiable in ``w``."""
    if w.dim() != 1 or ids.shape != w.shape:
        raise ValueError(f"segment_sum_scalar: w {tuple(w.shape)} and ids "
                         f"{tuple(ids.shape)} do not match")
    return _SegmentSumScalar.apply(w, ids, num_segments)


def _segment_sum_scalar(w, ids, num_segments: int):
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

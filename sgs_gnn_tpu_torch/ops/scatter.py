"""Segment sums over edge ids: the port of ``ops/scatter_pallas.py``.

Two kernels, each with its plain PyTorch version beside it. The wrapper
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.

``scatter_add(vals, ids, n)``: ``out[n] = sum_{ids[i]=n} vals[i]``, (E, F)
bf16 or f32 -> (N, F) f32. Replaces ``scatter_pallas.py:_scatter_kernel``
(behind ``scatter_add_pallas``), which turned the scatter into one-hot
matmuls because the TPU has no fast dynamic scatter. It is bound by bytes
(E*F*itemsize + 4E + 4NF: ~0.16 ms for E=1M, F=256 bf16 at 3.35 TB/s); what
costs the time beyond that is f32 atomics into a small output, and most ids
the main path feeds are unsorted (sampled edges). The kernel
(``csrc/scatter.cu``) has two routes, picked by :func:`scatter_plan` from
N, F and the value type: "slab" accumulates a W-column slab of all N rows
in shared memory per block, over a chunk of edges counting-sorted by id in
shared memory (shared-memory f32 atomics are CAS loops on sm_90; sorted,
a run inside a walker's range is added without them), and flushes it once
with 16-byte atomics ("sort" mode); a chunk whose ids look sorted adds runs
of whole rows with float4 atomics instead ("rows" mode). The mode is picked
per chunk from the ids on the card (:func:`slab_chunk_sorted` is the
test's twin) and counted there (:func:`slab_chunk_modes`). "direct" (N
too large for a slab) adds runs of equal ids straight into the output with
float4 atomics.

``segment_sum_scalar(w, ids, n)``: ``deg[n] = sum_{ids[i]=n} w[i]``, (E,)
f32 -> (N,) f32. Replaces ``scatter_pallas.py:_scalar_kernel`` (behind
``_segment_sum_scalar_pallas``), which rounds w to bf16; the port keeps
f32, as the JAX package's own CPU path does. Bound by bytes (8E: ~2.4 us
at E=1M). The kernel (``csrc/segment_sum.cu``) gives each block a
contiguous range of items (:func:`segment_plan`), sums runs of equal ids
inside a warp with a segmented shuffle scan, and adds each run once: into
the block's shared histogram, flushed over the id range the block touched
("shared" route), or, for N above the histogram, into the output ("global").

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
(``scatter_pallas.py:332-333``, XLA's ``g[ids]``), zero for dropped ids, in
the values' dtype: :func:`rows_at_cast`. On the CPU it is the plain
``rows_at(g, ids, n).to(dtype)``; on a card one pass of ``csrc/rows_at.cu``,
which reads each cotangent row from L2 and writes each output element once
(no TPU kernel's counterpart).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

# csrc/scatter.cu and csrc/segment_sum.cu geometry, and Hopper's limits
SMEM_LIMIT = 232_448       # opt-in shared memory of one block (227 KB)
SMEM_PER_SM = 233_472      # shared memory of one SM (228 KB)
H100_SMS = 132
SLAB_THREADS = 1024        # scatter.cu kSlabThreads
SLAB_MAX_COLS = 32         # a slab's columns are lanes of one warp
SORT_MAX_ITEMS = 1 << 15   # scatter.cu kMaxSubItems: offset bits of a key
SORT_MIN_ITEMS = 4096      # a slab route's sort pass, at least
SLAB_MAX_SEGMENTS = 1 << 16   # ids of a sort key (16 bits)
DIRECT_TILE = 256          # rows.cuh kRowTile: columns of a direct block
DIRECT_WARPS = 8           # scatter.cu kDirectWarps
DIRECT_EDGES_PER_WARP = 32
MAX_GRID_Y = 65_535
SEGMENT_SMEM_NODES = 12_288   # segment_sum.cu kSmemNodes
SEGMENT_STEP = 2048        # items of one unrolled block step (512 x 4)
SEGMENT_MIN_ITEMS = 2048   # items of one block at least


class ScatterPlan(NamedTuple):
    """How ``csrc/scatter.cu`` cuts one call: block (x, y) covers columns
    [x * col_tile, (x + 1) * col_tile) and items [y * chunk_items, (y + 1)
    * chunk_items), clipped to (F, E)."""
    route: str           # "slab" or "direct"
    col_tile: int        # slab columns W, or 256 (direct)
    col_tiles: int       # gridDim.x
    chunk_items: int     # edges of one block row
    chunks: int          # gridDim.y
    sub_items: int       # edges of one counting sort (slab), 0 (direct)
    smem_bytes: int      # slab_smem (slab), 0 (direct)


def slab_stride(n: int) -> int:
    """Column stride of a K1 slab: the smallest S >= n with S % 8 == 2
    (csrc/scatter.cu slab_stride: the lanes on one row hit distinct
    shared-memory banks)."""
    return n + (10 - n % 8) % 8


def slab_smem(n: int, w: int, sub_items: int) -> int:
    """Shared memory of a K1 slab block (csrc/scatter.cu slab_smem): the
    N x W slab, the sort's N-bin histogram, its sub_items keys and 32 ints
    of scan scratch."""
    return 4 * (w * slab_stride(n) + n + sub_items + 32)


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def scatter_plan(n: int, f: int, itemsize: int, e: int,
                 sms: int = H100_SMS) -> ScatterPlan:
    """K1's route and grid for N segments, F columns of ``itemsize``-byte
    values and E items on a card of ``sms`` SMs.

    The route is a function of (N, F, itemsize): "slab" where an N x W f32
    slab and a sort pass of 4096 edges fit in one block's shared memory with
    W (a power of two <= 32, no wider than F needs) at least one 32-byte
    sector of a value row (16 bf16 or 8 f32 columns, or all of F); else
    "direct". Slab blocks hold one SM each at N=2048, so the chunks fill one
    wave of the card's SMs, no shorter than max(2N, 2048) edges each, so that
    the flush (N x W adds per block) stays below the chunk's own adds; each
    chunk is sorted in as few equal passes as the shared memory left holds
    (at most 2^15 edges)."""
    cols = min(_pow2_at_least(f), SLAB_MAX_COLS)
    w = SLAB_MAX_COLS
    while w > 1 and slab_smem(n, w, SORT_MIN_ITEMS) > SMEM_LIMIT:
        w //= 2
    w = min(w, cols)
    need = min(32 // itemsize, cols)
    if (slab_smem(n, w, SORT_MIN_ITEMS) <= SMEM_LIMIT and w >= need
            and n < SLAB_MAX_SEGMENTS):
        col_tiles = -(-f // w)
        per_sm = max(1, min(SMEM_PER_SM // (slab_smem(n, w, SORT_MIN_ITEMS)
                                            + 1024), 2048 // SLAB_THREADS))
        chunks = max(1, min(sms * per_sm // col_tiles,
                            -(-e // max(2 * n, 2048))))
        chunk = -(-e // chunks)
        # the sort passes of a chunk: as few as the shared memory left to
        # per_sm blocks allows, of equal size
        room = min(SORT_MAX_ITEMS, (min(SMEM_LIMIT, SMEM_PER_SM // per_sm
                                        - 1024) - slab_smem(n, w, 0)) // 4)
        sub = -(-chunk // -(-chunk // room))
        return ScatterPlan("slab", w, col_tiles, chunk, -(-e // chunk), sub,
                           slab_smem(n, w, sub))
    per_warp = DIRECT_EDGES_PER_WARP * max(
        1, -(-e // (MAX_GRID_Y * DIRECT_WARPS * DIRECT_EDGES_PER_WARP)))
    chunk = DIRECT_WARPS * per_warp
    return ScatterPlan("direct", DIRECT_TILE, -(-f // DIRECT_TILE), chunk,
                       -(-e // chunk), 0, 0)


CHUNK_MODES = ("sort", "rows")   # scatter.cu: chunk_modes[0], [1]


def slab_chunk_sorted(ids, plan: ScatterPlan) -> np.ndarray:
    """(chunks,) bool: the chunks of a slab plan that take "rows" mode, as
    csrc/scatter.cu chunk_looks_sorted picks them: each of the block's
    1024 threads compares the item at e0 + t * step (step = max(1, chunk
    length // 1024)) with the next item and with the next sample; a chunk
    with no descent among them looks sorted."""
    ids = np.asarray(ids)
    e = ids.shape[0]
    out = np.zeros(plan.chunks, bool)
    for y in range(plan.chunks):
        e0 = y * plan.chunk_items
        e1 = min(e0 + plan.chunk_items, e)
        step = max(1, (e1 - e0) // SLAB_THREADS)
        p = e0 + np.arange(SLAB_THREADS, dtype=np.int64) * step
        p = p[p + 1 < e1]
        a = ids[p]
        far = p + step < e1
        descent = (a > ids[p + 1]) | (far & (a > ids[np.where(far, p + step,
                                                                p)]))
        out[y] = not descent.any()
    return out


# {card index: (2,) int32 on the card}: K1's slab chunks per mode
_chunk_modes: dict = {}


def _chunk_modes_buffer(device):
    buf = _chunk_modes.get(device.index)
    if buf is None:
        buf = _chunk_modes[device.index] = torch.zeros(
            len(CHUNK_MODES), dtype=torch.int32, device=device)
    return buf


def reset_slab_chunk_modes() -> None:
    """Sets the card's counts of K1's slab chunks per mode to 0 (a device
    memset; nothing waits)."""
    for buf in _chunk_modes.values():
        buf.zero_()


def slab_chunk_modes() -> dict:
    """{"sort": chunks, "rows": chunks}: the chunks of K1's slab route per
    mode since the last reset, summed over the cards, as the kernel counted
    them. Reads the card (the host waits for it)."""
    counts = np.zeros(len(CHUNK_MODES), np.int64)
    for buf in _chunk_modes.values():
        counts += np.asarray(buf.tolist(), np.int64)
    return dict(zip(CHUNK_MODES, counts.tolist()))


class SegmentPlan(NamedTuple):
    """How ``csrc/segment_sum.cu`` cuts one call: block b sums items [b *
    items_per_block, (b + 1) * items_per_block)."""
    route: str           # "shared" or "global"
    items_per_block: int
    blocks: int
    smem_bytes: int      # N * 4 (shared), 0 (global)


def segment_plan(n: int, e: int, sms: int = H100_SMS) -> SegmentPlan:
    """K2's route (a function of N: the shared histogram holds up to
    12,288 nodes) and its contiguous item ranges: about two blocks per SM,
    at least 2048 items each, in whole unrolled steps (at q=200k, 98 blocks
    of 2048 took 0.0051 ms on an H100, 49 of 4096 0.0074:
    tools/tune_row_kernels.py)."""
    items = max(SEGMENT_MIN_ITEMS, -(-e // (2 * sms)))
    items = -(-items // SEGMENT_STEP) * SEGMENT_STEP
    if n <= SEGMENT_SMEM_NODES:
        return SegmentPlan("shared", items, -(-e // items), 4 * n)
    return SegmentPlan("global", items, -(-e // items), 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def scatter_add_plain(vals, ids, num_segments: int,
                      acc_dtype=torch.float32):
    """Plain version: ``index_add_`` in ``acc_dtype``, which is also the
    output's dtype. With torch.float64 the sum of bf16 or f32 terms is
    exact to ~1e-16 relative in any order: the checks' reference."""
    keep = _in_range(ids, num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=acc_dtype,
                      device=vals.device)
    return out.index_add_(0, ids[keep].long(), vals[keep].to(acc_dtype))


def rows_at(g, ids, num_segments: int):
    """``g[ids]`` with zero rows where an id is outside [0, num_segments):
    the VJP of both segment sums, and how the head kernels read such ids."""
    keep = _in_range(ids, num_segments)
    rows = g[ids.clamp(0, max(num_segments - 1, 0)).long()]
    return torch.where(keep.reshape((-1,) + (1,) * (g.dim() - 1)), rows, 0)


def rows_at_cast(g, ids, num_segments: int, dtype):
    """``rows_at(g, ids, num_segments).to(dtype)``: the VJP of K1 (an (N, F)
    ``g``) and of K2 (an (N,) ``g``), bit for bit. The plain version on the
    CPU; on a card one launch of ``csrc/rows_at.cu`` into an uninitialised
    (E, F) or (E,) output, in 16-byte units where F and ``g``'s alignment
    allow, else element by element. ``g`` is f32 there: autograd hands
    both sums' backward the dtype of their f32 output."""
    if g.device.type == "cpu":
        return rows_at(g, ids, num_segments).to(dtype)
    g = g.contiguous()
    _build.check_cuda("rows_at", g, ids)
    if g.dtype != torch.float32 or \
            dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rows_at: g {g.dtype} to {dtype}, want float32 "
                        "to float32 or bfloat16")
    if ids.dtype != torch.int32:
        raise TypeError(f"rows_at: ids dtype {ids.dtype}, want int32")
    out = torch.empty(ids.shape + g.shape[1:], dtype=dtype, device=g.device)
    if out.numel() == 0:
        return out
    f = g.shape[1] if g.dim() == 2 else 1
    vec = 16 // out.element_size()
    vector = f % vec == 0 and g.data_ptr() % 16 == 0
    _build.call("rows_at", "sgs_rows_at", g.device, g.data_ptr(),
                ids.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
                ids.shape[0], f, num_segments, int(vector))
    return out


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
        return rows_at_cast(g, ids, ctx.num_segments, ctx.vals_dtype), \
            None, None


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
        return rows_at_cast(g, ids, ctx.num_segments, ctx.w_dtype), None, \
            None


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
    plan = scatter_plan(num_segments, f, vals.element_size(), e,
                        _sm_count(vals.device.index))
    _build.call("scatter_add", "sgs_scatter_add", vals.device,
                vals.data_ptr(), int(vals.dtype == torch.bfloat16),
                ids.data_ptr(), out.data_ptr(), e, f, num_segments,
                int(plan.route == "direct"), plan.col_tile,
                plan.chunk_items, plan.sub_items, plan.smem_bytes,
                _chunk_modes_buffer(vals.device).data_ptr(), route=plan.route)
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
                             block: int = 1024, acc_dtype=torch.float32):
    """Plain version: the band rule of ``sorted_band_keep``, then
    ``index_add_`` in ``acc_dtype`` (as ``scatter_add_plain``)."""
    keep = sorted_band_keep(ids_sorted, num_segments, band, block)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=acc_dtype,
                      device=vals.device)
    return out.index_add_(0, ids_sorted[keep].long(),
                          vals[keep].to(acc_dtype))


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


def segment_sum_scalar_plain(w, ids, num_segments: int,
                             acc_dtype=torch.float32):
    """Plain version: ``index_add_`` in ``acc_dtype`` (as
    ``scatter_add_plain``)."""
    keep = _in_range(ids, num_segments)
    out = torch.zeros(num_segments, dtype=acc_dtype, device=w.device)
    return out.index_add_(0, ids[keep].long(), w[keep].to(acc_dtype))


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
    plan = segment_plan(num_segments, w.shape[0], _sm_count(w.device.index))
    _build.call("segment_sum_scalar", "sgs_segment_sum_scalar", w.device,
                w.data_ptr(), ids.data_ptr(), out.data_ptr(), w.shape[0],
                num_segments, plan.items_per_block, route=plan.route)
    return out

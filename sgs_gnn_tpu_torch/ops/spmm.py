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
there. A call on a card that records no autograd graph, on shapes that
suit K8's tile route (serving, eval, any pass without a backward), runs
K8 instead (:func:`auto_route`): the gather, the weight multiply and K1
write, scale and re-read an (E, F) message matrix that K8 never forms.
Its products and sums are f32, never coarser than the bf16 messages. A
call that records a graph keeps the route above and its VJP;
``ROUTES[("spmm", route)]`` counts each "auto" call on the route it took,
and ``BYTES[("spmm", "gather_k1")]`` the E x F x itemsize bytes of the
message matrix each gather writes.

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

K8 has two routes, picked by :func:`spmm_plan` from the shapes and x's type
alone (never from tensor values, so a call needs no host read and can be
captured in a CUDA graph). "tiles" (bf16 x on graphs dense as matrices,
the cluster partitions the TPU kernel was written for): the edges are
counting-sorted on the card into 64 x 64 (receiver block, sender block)
tiles, each tile is densified in shared memory and multiplied by x's 64
sender rows on the tensor cores, the f32 sum of a tile's duplicate pairs
split into bf16 hi + lo. :func:`spmm_bin_plain` and
:func:`spmm_tiles_plain` follow that schedule in plain torch (the CPU tests
hold them to the plain version and to the Pallas kernel). "gather" (f32 x,
or sparser graphs): each warp gathers whole rows for a range of edges.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

from . import _build
from .edge_gather import gather_rows
from .scatter import (H100_SMS, _sm_count, rows_at, scatter_add,
                      scatter_add_plain)

BACKENDS = ("auto", "fused")

# csrc/spmm.cu geometry
TILE = 64                  # kTileRows = kTileK: receivers and senders a tile
PANEL_STRIDE = TILE + 4    # kPanelStride: floats per panel row
TILE_THREADS = 256         # two warpgroups
WINDOW = TILE_THREADS      # kWin: tile offsets a tile block holds at a time
BIN_CHUNK = 2048           # kBinChunk: edges of one binning block
MAX_BINS = 8192            # kMaxBins: tiles whose counts fit shared memory
WIDTHS = (16, 32, 48, 64, 96, 128, 192, 256)   # columns of a tile block
# The tile route needs at least this many edges per tile on average. A
# tile's fixed work is one read of its 64 sender rows (64 x W x 2 bytes);
# the gather route reads one row per edge (W x 2 bytes). Below 64 edges per
# tile the tiles move more bytes than the gathers they replace.
MIN_TILE_EDGES = 64
GATHER_COLS = 256          # rows.cuh kRowTile: columns of a gather block
GATHER_EDGES = 8 * 64      # kWarps * kEdgesPerWarp: edges of a gather block
GATHER_SMEM = 8 * GATHER_COLS * 4   # static staging rows


class SpmmPlan(NamedTuple):
    """How ``csrc/spmm.cu`` cuts one call. Tile route: block (p, c) takes
    the p-th of ``parts`` equal ranges of the binned edges and columns [c *
    width, (c + 1) * width) clipped to F; the binning runs over ``bins`` =
    ceil(N / 64)^2 tiles. Gather route: block (p, c) takes edges [p * 512,
    (p + 1) * 512) and columns [c * 256, (c + 1) * 256)."""
    route: str           # "tiles" or "gather"
    width: int           # columns of a block
    slices: int          # gridDim.y
    parts: int           # gridDim.x
    bins: int            # tiles (0 on the gather route)
    smem_bytes: int      # dynamic shared memory of the tile block (gather:
                         # its static staging)
    bin_smem_bytes: int  # of the binning's scatter block (0 on gather)


def tile_smem(width: int) -> int:
    """Shared memory of a tile block (csrc/spmm.cu tile_smem): two buffers
    of x's 64 rows of ``width`` bf16 columns, the hi and lo A images, the
    f32 panel, the window of WINDOW + 1 tile offsets (padded)."""
    return (2 * TILE * width * 2 + 2 * TILE * TILE * 2
            + TILE * PANEL_STRIDE * 4 + (WINDOW + 4) * 4)


def bin_smem(bins: int) -> int:
    """Shared memory of a binning scatter block (csrc/spmm.cu bin_smem):
    the chunk's counts (bins rounded up to 32: a swizzled histogram), three
    ints per bin, a code and a tile per edge of the chunk."""
    return 4 * (-(-bins // 32) * 32) + 12 * bins + 8 * BIN_CHUNK


def tile_width(f: int) -> int:
    """Columns of a tile block: F rounded up to a multiple of 16 (each of
    the two warpgroups takes half, a wgmma width is a multiple of 8), then
    to the next width the kernel is built for; 256 above that, in slices."""
    f16 = -(-f // 16) * 16
    return next((w for w in WIDTHS if w >= f16), WIDTHS[-1])


def parts_per_sm(width: int) -> int:
    """Tile blocks resident on one SM at ``width`` columns (registers, as
    ptxas gave them on sm_90a: 40-55 a thread up to 64 columns, 72 at 96
    and 128, 128 above (the launch bound); shared memory allows as many):
    the block is latency-bound, so the grid fills them all."""
    return 4 if width <= 64 else 3 if width <= 128 else 2


def spmm_plan(n: int, f: int, e: int, itemsize: int,
              sms: int = H100_SMS) -> SpmmPlan:
    """K8's route and grid for N nodes, F columns of ``itemsize``-byte x
    and E edges on a card of ``sms`` SMs.

    "tiles" for bf16 x (itemsize 2) when ceil(N/64)^2 tiles fit the
    binning's shared histogram (``MAX_BINS``) and the graph has at least
    ``MIN_TILE_EDGES`` edges per tile on average; else "gather". f32 x
    always takes "gather": the Pallas kernel multiplies f32 at
    Precision.HIGHEST, and the tensor cores have no full-f32 product. The
    tile route's parts fill :func:`parts_per_sm` blocks on every SM across
    the column slices, each part at least 512 edges."""
    sblocks = -(-n // TILE)
    bins = sblocks * sblocks
    if itemsize == 2 and bins <= MAX_BINS and e >= MIN_TILE_EDGES * bins:
        width = tile_width(f)
        slices = -(-f // width)
        parts = max(1, min(-(-parts_per_sm(width) * sms // slices),
                           -(-e // 512)))
        return SpmmPlan("tiles", width, slices, parts, bins,
                        tile_smem(width), bin_smem(bins))
    return SpmmPlan("gather", GATHER_COLS, -(-f // GATHER_COLS),
                    -(-e // GATHER_EDGES), 0, GATHER_SMEM, 0)


def scratch_ints(plan: SpmmPlan, e: int) -> int:
    """int32 scratch of the tile route (csrc/spmm.cu launch_tile_route):
    counts, cursors, a flag, offsets (bins + 1), one 4-byte code per edge."""
    return 3 * plan.bins + 2 + e


def part_range(total: int, p: int, parts: int) -> tuple[int, int]:
    """The binned edges [begin, end) of tile part ``p``."""
    return total * p // parts, total * (p + 1) // parts


def auto_route(device_type: str, records_grad: bool, plan_route: str) -> str:
    """The route of ``spmm(backend="auto")``: "k8_tiles" (K8, one pass, no
    message matrix) for a call on a CUDA device that records no autograd
    graph and whose :func:`spmm_plan` is "tiles"; "gather_k1" (the gather,
    the weight multiply and K1) for every other call: one that records a
    graph, the CPU, f32 x, sparse graphs."""
    if device_type == "cuda" and not records_grad and plan_route == "tiles":
        return "k8_tiles"
    return "gather_k1"


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
    records_grad = torch.is_grad_enabled() and (
        x.requires_grad or (weights is not None and weights.requires_grad))
    # K8 reads x's rows by sender id: only a square A_w (a halo's extended
    # table has more rows than receivers)
    plan_route = (spmm_plan(num_nodes, x.shape[1], senders.shape[0],
                            x.element_size()).route
                  if x.shape[0] == num_nodes else "")
    route = auto_route(x.device.type, records_grad, plan_route)
    _build.ROUTES["spmm", route] += 1
    if route == "k8_tiles":
        if weights is None:
            weights = torch.ones(senders.shape[0], dtype=torch.float32,
                                 device=x.device)
        return _SpmmFused.apply(senders.int(), receivers.int(), weights, x,
                                num_nodes)
    _build.BYTES["spmm", route] += (senders.shape[0] * x.shape[1]
                                    * x.element_size())
    msgs = gather_rows(x, senders)
    if weights is not None:
        msgs = msgs * weights[:, None].to(x.dtype)
    return scatter_add(msgs, receivers, num_nodes).to(x.dtype)


def spmm_fused_plain(senders, receivers, weights, x, num_nodes: int,
                     acc_dtype=torch.float32):
    """Plain version of K8: products of the ``x.dtype``-rounded weight and
    x rows, summed by ``index_add_``, all in ``acc_dtype``; (N, F) of
    ``acc_dtype``. With torch.float64 the products of bf16 or f32 factors
    are exact and the sums exact to ~1e-16 relative. Edges with an
    endpoint outside [0, N) contribute nothing."""
    w = weights.to(x.dtype).to(acc_dtype)
    msgs = rows_at(x, senders, num_nodes).to(acc_dtype) * w[:, None]
    return scatter_add_plain(msgs, receivers, num_nodes, acc_dtype)


def spmm_bin_plain(senders, receivers, weights, num_nodes: int):
    """The tile route's binning (csrc/spmm.cu spmm_bin_*_kernel) in plain
    torch: the in-range edges in tile order (receiver block major, sender
    block minor; stable within a tile, where the card's order is not
    fixed). Returns (offsets (bins + 1,) int64, the edges' places in their
    tiles (r % 64) * 64 + s % 64 (int64), their weights rounded to bf16 as
    f32)."""
    s, r = senders.long(), receivers.long()
    keep = (s >= 0) & (s < num_nodes) & (r >= 0) & (r < num_nodes)
    s, r, w = s[keep], r[keep], weights[keep]
    sblocks = -(-num_nodes // TILE)
    key = (r // TILE) * sblocks + s // TILE
    order = torch.argsort(key, stable=True)
    offsets = torch.zeros(sblocks * sblocks + 1, dtype=torch.int64,
                          device=key.device)
    offsets[1:] = torch.cumsum(torch.bincount(key, minlength=sblocks
                                              * sblocks), 0)
    at = ((r % TILE) * TILE + s % TILE)[order]
    return offsets, at, w.to(torch.bfloat16).float()[order]


def spmm_tiles_plain(senders, receivers, weights, x, num_nodes: int,
                     plan: SpmmPlan | None = None):
    """The tile route's schedule in plain torch, (N, F) float32: bin the
    edges, then for each column slice and part the tiles its range touches:
    densify the part's edges of a tile into a 64 x 64 f32 panel, split it
    into bf16 hi and lo = bf16(panel - hi), multiply both by the tile's
    bf16 sender rows in f32, accumulate per receiver block and add the
    block into the output when the part leaves it (split-K)."""
    n, f = x.shape
    if plan is None:
        plan = spmm_plan(n, f, senders.shape[0], 2)
    offsets, at, wb = spmm_bin_plain(senders, receivers, weights, num_nodes)
    off = offsets.tolist()
    sblocks = -(-num_nodes // TILE)
    xb = x.to(torch.bfloat16).float()
    out = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    total = off[-1]

    def flush(acc, rb, c0):
        rows = min(TILE, n - rb * TILE)
        out[rb * TILE:rb * TILE + rows, c0:c0 + acc.shape[1]] += acc[:rows]

    for c in range(plan.slices):
        c0 = c * plan.width
        cols = min(plan.width, f - c0)
        for p in range(plan.parts):
            begin, end = part_range(total, p, plan.parts)
            if begin >= end:
                continue
            t = bisect.bisect_right(off, begin) - 1
            cur = t // sblocks
            acc = torch.zeros((TILE, cols), dtype=torch.float32,
                              device=x.device)
            while t < len(off) - 1 and off[t] < end:
                lo, hi = max(off[t], begin), min(off[t + 1], end)
                if hi > lo:
                    rb, sb = divmod(t, sblocks)
                    if rb != cur:
                        flush(acc, cur, c0)
                        acc.zero_()
                        cur = rb
                    panel = torch.zeros(TILE * TILE, dtype=torch.float32,
                                        device=x.device).index_add_(
                        0, at[lo:hi], wb[lo:hi]).view(TILE, TILE)
                    a_hi = panel.to(torch.bfloat16)
                    a_lo = (panel - a_hi.float()).to(torch.bfloat16)
                    xt = torch.zeros((TILE, cols), dtype=torch.float32,
                                     device=x.device)
                    rows = xb[sb * TILE:(sb + 1) * TILE, c0:c0 + cols]
                    xt[:rows.shape[0]] = rows
                    acc += a_hi.float() @ xt
                    acc += a_lo.float() @ xt
                t += 1
            flush(acc, cur, c0)
    return out


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
    if e == 0 or f == 0 or num_nodes == 0:
        return torch.zeros((num_nodes, f), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((num_nodes, f), dtype=torch.float32, device=x.device)
    plan = spmm_plan(num_nodes, f, e, x.element_size(),
                     _sm_count(x.device.index))
    tiles = plan.route == "tiles"
    scratch = (torch.empty(scratch_ints(plan, e), dtype=torch.int32,
                           device=x.device) if tiles else None)
    _build.call("spmm_fused", "sgs_spmm_fused", x.device, senders.data_ptr(),
                receivers.data_ptr(), weights.data_ptr(), x.data_ptr(),
                int(x.dtype == torch.bfloat16), out.data_ptr(), e,
                num_nodes, f, plan.width if tiles else 0, plan.parts,
                scratch.data_ptr() if tiles else None, route=plan.route)
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

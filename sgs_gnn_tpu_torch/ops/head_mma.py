"""Host side of the tensor-core forward head (``csrc/head_mma.cuh``), the
bf16 route of K3 (``score_sampled``) and K6 (``score_tiles``).

The kernel reads W1 = [W1a; W1b] through wgmma descriptors from shared
memory, in chunks that a bulk copy lands ready to use. ``pack_head_weights``
builds that image once per call, in plain torch on the weights' device:
for each K tile of ``N_TILE`` hidden columns and each chunk of ``CHUNK``
feature rows, the W1a slice then the W1b slice, each (N_TILE n x CHUNK k)
in K-major core matrices of 8 x 8 elements (128 bytes), core matrix
(n // 8, k // 8) at element (n // 8) * 512 + (k // 8) * 64. F and K are
zero-padded to those multiples. ``head_rows`` gives h 16-byte rows for the
kernel's 16-byte gathers.

``score_head_mma_plain`` follows the kernel's schedule in plain torch: edge
tiles of ``EDGE_TILE``, K tiles of at most ``N_TILE`` real columns, feature
chunks of ``CHUNK`` that feed both halves from the packed image, the
epilogue's dropout counters e * K + k over the real columns only. The CPU
tests hold it to ``score_head_plain`` and to the JAX kernel.

The backward (``csrc/head_bwd_mma.cuh``, the bf16 route of K5) runs three
kernels. The dz1 pass is the forward's schedule with a new epilogue; it
writes dz1 rounded to h's type into a scratch image (``dz1_offset``): per
block of ``DZ1_ROWS`` edges and K tile, 8-edge groups of ``N_TILE // 8``
core matrices of 8 edges x 8 hidden columns. The dh pass reads it as a
K-major A operand (hidden chunks of ``CHUNK``) against W1a^T and W1b^T,
packed once per call by ``pack_head_weights_t`` in feature parts of
``F_PART``; the weight pass reads the same bytes as an MN-major B operand
(64 edges x 256 hidden per bulk copy) against the gathered products read
MN-major, over ``weight_splits`` ranges of the edges.
``score_head_bwd_mma_plain`` follows those three schedules in plain torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .dropout import HeadDropout, hash32_plain
from .scatter import rows_at, scatter_add_plain

# mirrored from csrc/head_mma.cuh
CHUNK = 64        # feature columns per reduction chunk (kChunk)
N_TILE = 256      # hidden columns per K tile, the wgmma N (kN)
EDGE_TILE = 128   # edges per tile: two warpgroups of 64 rows (kRows)
ROW_ALIGN = 8     # h's row pitch in elements: 16-byte rows
STAGES = 2        # weight ring depth (kStages)
# dynamic shared memory of a block (kSmemBytes): the weight ring, two
# A_prod/A_diff buffers per warpgroup, the ring's mbarriers
SMEM_BYTES = (STAGES * 2 * N_TILE * CHUNK * 2 + 2 * 2 * 2 * 64 * CHUNK * 2
              + 2 * STAGES * 8)
# the backward (csrc/head_bwd_mma.cuh)
F_PART = 128       # features per accumulator of the dh pass (kFPart)
DZ1_ROWS = 64      # edges per block of the dz1 image: one warpgroup's rows
SPLIT_CHUNK = 64   # edges per MMA chunk of the weight pass (kSplitChunk)
BWD_STAGES = 3     # ring depth of the dh and weight passes (kBwdStages)
STAGE_ROW = F_PART + 8   # floats per row of the dh pass's staging area


def bwd_smem_bytes(k: int):
    """Dynamic shared memory of the backward's three kernels at K = k:
    {dz1, dh, dw} (kDz1Smem, kDhSmem, kDwSmem in the source)."""
    a_chunk = EDGE_TILE * CHUNK * 2
    b_chunk = 2 * F_PART * CHUNK * 2
    return {
        # the forward's layout + db1 and dw2 partials (2K floats) + db2,
        # then the (b1, w2) pairs of the padded columns
        "dz1": SMEM_BYTES + (2 * k + 4) * 4 + _round_up(k, N_TILE) * 8,
        # ring of (dz1 chunk, W1a^T and W1b^T chunks), dh_u staging, the
        # sorted side's ids, the ring's barriers
        "dh": (BWD_STAGES * (a_chunk + b_chunk) + 2 * 64 * STAGE_ROW * 4
               + EDGE_TILE * 4 + 2 * BWD_STAGES * 8),
        # ring of dz1 (64 edges x 256 hidden), 3 x (A_prod, A_diff), barriers
        "dw": (BWD_STAGES * SPLIT_CHUNK * N_TILE * 2
               + BWD_STAGES * 2 * SPLIT_CHUNK * CHUNK * 2
               + 2 * BWD_STAGES * 8),
    }


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_dims(f: int, k: int):
    """(F, K) padded to the kernel's chunk and K tile."""
    return _round_up(f, CHUNK), _round_up(k, N_TILE)


def pack_head_weights(w1a, w1b):
    """[W1a; W1b], each (F, K), as the kernel's shared-memory image: a flat
    tensor of shape (K tiles * chunks * 2 * N_TILE * CHUNK,) in their dtype,
    ordered [K tile][chunk][W1a, W1b][n // 8][k // 8][n % 8][k % 8]."""
    f, k = w1a.shape
    fp, kp = padded_dims(f, k)
    nc, nt = fp // CHUNK, kp // N_TILE
    halves = []
    for w in (w1a, w1b):
        wp = F.pad(w, (0, kp - k, 0, fp - f))
        # [c, k // 8, k % 8, t, n // 8, n % 8] -> [t, c, n // 8, k // 8,
        # n % 8, k % 8]
        halves.append(wp.reshape(nc, CHUNK // 8, 8, nt, N_TILE // 8, 8)
                      .permute(3, 0, 4, 1, 5, 2))
    return torch.stack(halves, dim=2).contiguous().reshape(-1)


def unpack_head_weights(packed, f: int, k: int):
    """The padded (2, Fp, Kp) [W1a, W1b] that ``packed`` holds; the real
    halves are ``[:, :f, :k]``."""
    fp, kp = padded_dims(f, k)
    nc, nt = fp // CHUNK, kp // N_TILE
    image = packed.reshape(nt, nc, 2, N_TILE // 8, CHUNK // 8, 8, 8)
    return image.permute(2, 1, 4, 6, 0, 3, 5).reshape(2, fp, kp)


def chunk_weights(packed, f: int, k: int, t: int, c: int, half: int):
    """The (CHUNK, N_TILE) slice of W1a (half 0) or W1b (half 1) that K tile
    t and chunk c read, from the packed image."""
    fp, kp = padded_dims(f, k)
    image = packed.reshape(kp // N_TILE, fp // CHUNK, 2, N_TILE // 8,
                           CHUNK // 8, 8, 8)[t, c, half]
    return image.permute(1, 3, 0, 2).reshape(CHUNK, N_TILE)


def head_rows(h):
    """(h with 16-byte rows, its row pitch in elements): h itself when F is
    a multiple of ``ROW_ALIGN`` and its data 16-byte aligned, else a copy
    with zero columns appended."""
    f = h.shape[1]
    pitch = _round_up(f, ROW_ALIGN)
    if pitch != f:
        return F.pad(h, (0, pitch - f)), pitch
    if h.data_ptr() % 16:
        return h.clone(), pitch
    return h, pitch


def _ktile_acc(hu, hv, packed, f: int, k: int, t: int):
    """(rows, N_TILE) f32: the first layer (without b1) of K tile t for
    gathered rows hu, hv (feature-padded to the chunks), chunk by chunk, both
    halves from one gathered slice rounded to h's type."""
    acc = torch.zeros((hu.shape[0], N_TILE), dtype=torch.float32,
                      device=hu.device)
    for c in range(hu.shape[1] // CHUNK):
        u = hu[:, c * CHUNK:(c + 1) * CHUNK]
        v = hv[:, c * CHUNK:(c + 1) * CHUNK]
        acc += (u * v).float() @ chunk_weights(packed, f, k, t, c, 0).float()
        acc += (u - v).float() @ chunk_weights(packed, f, k, t, c, 1).float()
    return acc


def _keep_bits(drop, e0: int, rows: int, k: int, cols):
    """The dropout keep mask of slots e0.. over the real columns ``cols``
    (None without dropout)."""
    if drop is None or not drop.thresh:
        return None
    e = torch.arange(e0, e0 + rows, device=cols.device)
    return hash32_plain(drop.seed, e[:, None] * k + cols) >= drop.thresh


def score_head_mma_plain(h, packed, b1, w2, b2, senders, receivers,
                         drop: HeadDropout = None):
    """(q,) f32 probabilities computed in the kernel's schedule from the
    packed W1 (``pack_head_weights``) and the head's f32 b1, w2, b2."""
    n, f = h.shape
    k = b1.shape[0]
    fp, kp = padded_dims(f, k)
    q = senders.shape[0]
    out = torch.empty(q, dtype=torch.float32, device=h.device)
    for e0 in range(0, q, EDGE_TILE):
        hu = F.pad(rows_at(h, senders[e0:e0 + EDGE_TILE], n), (0, fp - f))
        hv = F.pad(rows_at(h, receivers[e0:e0 + EDGE_TILE], n), (0, fp - f))
        rows = hu.shape[0]
        logit = torch.zeros(rows, dtype=torch.float32, device=h.device)
        for t in range(kp // N_TILE):
            acc = _ktile_acc(hu, hv, packed, f, k, t)
            cols = torch.arange(t * N_TILE, min(k, (t + 1) * N_TILE),
                                device=h.device)
            z = torch.relu(acc[:, :cols.shape[0]] + b1[cols])
            keep = _keep_bits(drop, e0, rows, k, cols)
            if keep is not None:
                z = torch.where(keep, z * drop.scale, 0.0)
            logit += z @ w2[cols]
        out[e0:e0 + rows] = torch.sigmoid(logit + b2)
    return out


def pack_head_weights_t(w1a, w1b):
    """[W1a^T; W1b^T] as the dh pass's shared-memory image: W1a and W1b,
    each (F, K), zero-padded to (F_PART, N_TILE) multiples, as a flat tensor
    in their dtype ordered [feature part][hidden chunk][W1a, W1b][n // 8]
    [k // 8][n % 8][k % 8], n a feature of the part (the wgmma N), k a
    hidden column of the chunk (the reduction, K-major)."""
    f, k = w1a.shape
    ft, kp = _round_up(f, F_PART), _round_up(k, N_TILE)
    halves = []
    for w in (w1a, w1b):
        wp = F.pad(w, (0, kp - k, 0, ft - f))
        # [p, n // 8, n % 8, hc, k // 8, k % 8] -> [p, hc, n // 8, k // 8,
        # n % 8, k % 8]
        halves.append(wp.reshape(ft // F_PART, F_PART // 8, 8, kp // CHUNK,
                                 CHUNK // 8, 8).permute(0, 3, 1, 4, 2, 5))
    return torch.stack(halves, dim=2).contiguous().reshape(-1)


def unpack_head_weights_t(packed, f: int, k: int):
    """The padded (2, Kp, Ft) [W1a^T, W1b^T] that ``packed`` holds; the real
    halves are ``[:, :k, :f]``."""
    ft, kp = _round_up(f, F_PART), _round_up(k, N_TILE)
    image = packed.reshape(ft // F_PART, kp // CHUNK, 2, F_PART // 8,
                           CHUNK // 8, 8, 8)
    return image.permute(2, 1, 4, 6, 0, 3, 5).reshape(2, kp, ft)


def chunk_weights_t(packed, f: int, k: int, part: int, hc: int, half: int):
    """The (CHUNK, F_PART) slice of W1a^T (half 0) or W1b^T (half 1) that
    feature part ``part`` and hidden chunk ``hc`` read."""
    ft, kp = _round_up(f, F_PART), _round_up(k, N_TILE)
    image = packed.reshape(ft // F_PART, kp // CHUNK, 2, F_PART // 8,
                           CHUNK // 8, 8, 8)[part, hc, half]
    return image.permute(1, 3, 0, 2).reshape(CHUNK, F_PART)


def dz1_numel(q: int, k: int) -> int:
    """Elements of the dz1 scratch image: every row of every edge tile."""
    return -(-q // EDGE_TILE) * EDGE_TILE * _round_up(k, N_TILE)


def dz1_offset(e, c, k: int):
    """Element offset of dz1[e, c] in the scratch image: [e // 64][c //
    256][e % 64 // 8][c % 256 // 8][e % 8][c % 8]."""
    kp = _round_up(k, N_TILE)
    return ((e // DZ1_ROWS) * DZ1_ROWS * kp + (c // N_TILE) * DZ1_ROWS
            * N_TILE + (e % DZ1_ROWS // 8) * 8 * N_TILE
            + (c % N_TILE // 8) * 64 + (e % 8) * 8 + c % 8)


def _to_dz1_image(rows):
    """(m * 64, Kp) -> the image's blocks of those rows, flat."""
    m, kp = rows.shape[0] // DZ1_ROWS, rows.shape[1]
    return rows.reshape(m, 8, 8, kp // N_TILE, N_TILE // 8, 8) \
        .permute(0, 3, 1, 4, 2, 5).reshape(-1)


def _from_dz1_image(flat, kp: int):
    """Inverse of ``_to_dz1_image``: (m * 64, Kp) rows."""
    m = flat.numel() // (DZ1_ROWS * kp)
    return flat.reshape(m, kp // N_TILE, 8, N_TILE // 8, 8, 8) \
        .permute(0, 2, 4, 1, 3, 5).reshape(m * DZ1_ROWS, kp)


def weight_splits(q: int, f: int, k: int, sms: int = 132):
    """(edges per split, splits) of the weight pass: a grid of (F chunks, K
    tiles, splits) blocks of one per SM, each split a whole number of
    SPLIT_CHUNK-edge chunks (as launch_bwd in the source)."""
    fp, kp = padded_dims(f, k)
    per_grid = (fp // CHUNK) * (kp // N_TILE)
    chunks = max(-(-q // SPLIT_CHUNK), 1)
    splits = min(max(-(-sms // per_grid), 1), chunks)
    per = -(-chunks // splits)
    return per * SPLIT_CHUNK, -(-chunks // per)


def score_head_bwd_mma_plain(h, packed, packed_t, b1, w2, b2, senders,
                             receivers, dp, drop: HeadDropout = None,
                             sms: int = 132):
    """f32 (dh, dW1a, dW1b, db1, dw2, db2) computed in the three backward
    kernels' schedules from the forward's packed W1 (``pack_head_weights``),
    the transposed image (``pack_head_weights_t``) and f32 b1, w2, b2."""
    n, f = h.shape
    k = b1.shape[0]
    fp, kp = padded_dims(f, k)
    ft = _round_up(f, F_PART)
    q = senders.shape[0]
    dev = h.device
    dh = torch.zeros((n, f), dtype=torch.float32, device=dev)
    dw1 = torch.zeros((2, f, k), dtype=torch.float32, device=dev)
    db1 = torch.zeros(k, dtype=torch.float32, device=dev)
    dw2 = torch.zeros(k, dtype=torch.float32, device=dev)
    db2 = torch.zeros(1, dtype=torch.float32, device=dev)
    image = torch.empty(dz1_numel(q, k), dtype=h.dtype, device=dev)
    tile_numel = EDGE_TILE * kp

    def gathered(e0, rows, width):
        return [F.pad(rows_at(h, ids[e0:e0 + rows], n), (0, width - f))
                for ids in (senders, receivers)]

    # dz1 pass: 128-edge tiles; the logits over every K tile, then each K
    # tile's epilogue (z recomputed when K spans several tiles: the same
    # values); dz1 rounded to h's type per tile into the image
    for e0 in range(0, q, EDGE_TILE):
        rows = min(EDGE_TILE, q - e0)
        hu, hv = gathered(e0, rows, fp)
        logit = torch.zeros(rows, dtype=torch.float32, device=dev)
        tiles = []
        for t in range(kp // N_TILE):
            cols = torch.arange(t * N_TILE, min(k, (t + 1) * N_TILE),
                                device=dev)
            z = _ktile_acc(hu, hv, packed, f, k, t)[:, :cols.shape[0]] \
                + b1[cols]
            keep = _keep_bits(drop, e0, rows, k, cols)
            zd = torch.relu(z)
            if keep is not None:
                zd = torch.where(keep, zd * drop.scale, 0.0)
            logit += zd @ w2[cols]
            tiles.append((cols, z, keep, zd))
        p = torch.sigmoid(logit + b2)
        dl = dp[e0:e0 + rows].float() * p * (1.0 - p)
        db2 += dl.sum()
        dz1c = torch.zeros((EDGE_TILE, kp), dtype=h.dtype, device=dev)
        for cols, z, keep, zd in tiles:
            dw2[cols] += (zd * dl[:, None]).sum(0)
            dzr = dl[:, None] * w2[cols]
            if keep is not None:
                dzr = torch.where(keep, dzr * drop.scale, 0.0)
            dz = torch.where(z > 0.0, dzr, 0.0)
            db1[cols] += dz.sum(0)
            dz1c[:rows, cols] = dz.to(h.dtype)
        t0 = e0 // EDGE_TILE * tile_numel
        image[t0:t0 + tile_numel] = _to_dz1_image(dz1c)

    # dh pass: per tile and feature part, dprod / ddiff over the hidden
    # chunks of the image against W1a^T / W1b^T, then dh_u / dh_v rounded to
    # h's type and scattered (the kernel merges runs of the sorted side)
    for e0 in range(0, q, EDGE_TILE):
        rows = min(EDGE_TILE, q - e0)
        hu, hv = gathered(e0, rows, ft)
        t0 = e0 // EDGE_TILE * tile_numel
        a = _from_dz1_image(image[t0:t0 + tile_numel], kp)[:rows]
        for part in range(ft // F_PART):
            dprod = torch.zeros((rows, F_PART), device=dev)
            ddiff = torch.zeros((rows, F_PART), device=dev)
            for hc in range(kp // CHUNK):
                ac = a[:, hc * CHUNK:(hc + 1) * CHUNK].float()
                dprod += ac @ chunk_weights_t(packed_t, f, k, part, hc,
                                              0).float()
                ddiff += ac @ chunk_weights_t(packed_t, f, k, part, hc,
                                              1).float()
            c0, c1 = part * F_PART, min(f, (part + 1) * F_PART)
            u = hu[:, c0:c0 + F_PART].float()
            v = hv[:, c0:c0 + F_PART].float()
            dhu = (dprod * v + ddiff).to(h.dtype)[:, :c1 - c0]
            dhv = (dprod * u - ddiff).to(h.dtype)[:, :c1 - c0]
            dh[:, c0:c1] += scatter_add_plain(dhu, senders[e0:e0 + rows], n)
            dh[:, c0:c1] += scatter_add_plain(dhv, receivers[e0:e0 + rows],
                                              n)

    # weight pass: per split of the edges, feature chunk and K tile, a
    # (CHUNK, N_TILE) sum over 64-edge chunks of prod^T / diff^T (gathered
    # rows, h's type) times the image's (64, N_TILE) block
    per, _ = weight_splits(q, f, k, sms)
    for e_begin in range(0, q, per):
        e_end = min(q, e_begin + per)
        for c in range(fp // CHUNK):
            fc = slice(c * CHUNK, (c + 1) * CHUNK)
            for t in range(kp // N_TILE):
                acc = torch.zeros((2, CHUNK, N_TILE), device=dev)
                for e0 in range(e_begin, e_end, SPLIT_CHUNK):
                    rows = min(SPLIT_CHUNK, e_end - e0)
                    hu, hv = gathered(e0, rows, fp)
                    u, v = hu[:, fc], hv[:, fc]
                    b0 = e0 // DZ1_ROWS * DZ1_ROWS * kp
                    blk = _from_dz1_image(image[b0:b0 + DZ1_ROWS * kp], kp)
                    b = blk[:rows, t * N_TILE:(t + 1) * N_TILE].float()
                    acc[0] += (u * v).float().t() @ b
                    acc[1] += (u - v).float().t() @ b
                f1, k1 = min(f, (c + 1) * CHUNK), min(k, (t + 1) * N_TILE)
                dw1[:, c * CHUNK:f1, t * N_TILE:k1] += \
                    acc[:, :f1 - c * CHUNK, :k1 - t * N_TILE]
    return dh, dw1[0], dw1[1], db1, dw2, db2

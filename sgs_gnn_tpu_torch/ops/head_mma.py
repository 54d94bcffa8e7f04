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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .dropout import HeadDropout, hash32_plain
from .scatter import rows_at

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
            acc = torch.zeros((rows, N_TILE), dtype=torch.float32,
                              device=h.device)
            for c in range(fp // CHUNK):
                u = hu[:, c * CHUNK:(c + 1) * CHUNK]
                v = hv[:, c * CHUNK:(c + 1) * CHUNK]
                # both halves from one gathered slice, rounded to h's type
                acc += (u * v).float() @ chunk_weights(
                    packed, f, k, t, c, 0).float()
                acc += (u - v).float() @ chunk_weights(
                    packed, f, k, t, c, 1).float()
            cols = torch.arange(t * N_TILE, min(k, (t + 1) * N_TILE),
                                device=h.device)
            z = torch.relu(acc[:, :cols.shape[0]] + b1[cols])
            if drop is not None and drop.thresh:
                e = torch.arange(e0, e0 + rows, device=h.device)
                bits = hash32_plain(drop.seed, e[:, None] * k + cols)
                z = torch.where(bits >= drop.thresh, z * drop.scale, 0.0)
            logit += z @ w2[cols]
        out[e0:e0 + rows] = torch.sigmoid(logit + b2)
    return out

"""Tile-pair edge scoring: the port of ``ops/score_tiles.py``.

The hybrid pipeline's detached sampling pass scores every edge. Host-side,
once per static edge list, ``build_tile_index`` buckets the edges by tile
pair (sender // t, receiver // t) and pads each bucket to a multiple of b
slots (own copy of the JAX function, same arrays). ``score_head_tiles``
then scores every slot in TILE order; sampling is order-invariant, so the
caller samples in tile space (``Graph.tile_prob`` / ``tile_mask``) and maps
only the q winners back.

On a CUDA tensor it launches K6 (``csrc/score_tiles.cu``), which replaces
``score_tiles.py:_make_kernel`` (behind ``_score_tiles_call``): the same
head code and dropout mask as K3, with slot e's endpoints su[e // b] * t +
ls[e] and rv[e // b] * t + lr[e], and K3's dispatch on h's dtype (bf16 on
the tensor cores, f32 on CUDA cores). On the CPU the plain version runs. The
pass is detached by construction: it runs under ``torch.no_grad`` and
returns a tensor that does not require grad, as the JAX op cuts the
tangents at its inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .dropout import HeadDropout
from .score_sampled import (PLAIN_CHUNK, _check_kernel_inputs,
                            kernel_operands, score_head_plain, split_head)


def _round_up(x, m):
    return (x + m - 1) // m * m


class TileIndex(NamedTuple):
    """Host-built static index (numpy) for the tile-pair kernel."""
    ls: np.ndarray        # (Ep,) int32 sender id local to its T-row tile
    lr: np.ndarray        # (Ep,) int32 receiver id local to its tile
    su: np.ndarray        # (nblocks,) int32 sender tile index per block
    rv: np.ndarray        # (nblocks,) int32 receiver tile index per block
    perm: np.ndarray      # (Ep,) int32 original edge id (0 on padding)
    valid: np.ndarray     # (Ep,) bool, False on padding slots
    t: int                # tile rows
    b: int                # edges per block
    n_pad: int            # node count padded to a tile multiple


def build_tile_index(senders, receivers, num_nodes: int, t: int = 128,
                     b: int = 512,
                     max_overhead: float = 1.35) -> Optional[TileIndex]:
    """Bucket edges by (sender//t, receiver//t); pad buckets to b-multiples.
    Returns None when the padded layout would exceed ``max_overhead`` x E.
    (Own copy of the JAX ``build_tile_index``.)"""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    e = s.shape[0]
    if e == 0:
        return None
    n_pad = _round_up(max(num_nodes, t), t)
    nt = n_pad // t
    pair = (s // t) * nt + (r // t)
    order = np.argsort(pair, kind="stable").astype(np.int64)
    uniq, counts = np.unique(pair[order], return_counts=True)
    padded = (np.ceil(counts / b).astype(np.int64)) * b
    total = int(padded.sum())
    if total > max_overhead * e:
        return None
    ls = np.zeros(total, np.int32)
    lr = np.zeros(total, np.int32)
    perm = np.zeros(total, np.int32)
    valid = np.zeros(total, bool)
    su = np.empty(total // b, np.int32)
    rv = np.empty(total // b, np.int32)
    off_in = off_out = blk = 0
    for pid, c, pc in zip(uniq, counts, padded):
        sel = order[off_in:off_in + c]
        ls[off_out:off_out + c] = (s[sel] % t).astype(np.int32)
        lr[off_out:off_out + c] = (r[sel] % t).astype(np.int32)
        perm[off_out:off_out + c] = sel.astype(np.int32)
        valid[off_out:off_out + c] = True
        nb = int(pc // b)
        su[blk:blk + nb] = int(pid // nt)
        rv[blk:blk + nb] = int(pid % nt)
        off_in += c
        off_out += int(pc)
        blk += nb
    return TileIndex(ls=ls, lr=lr, su=su, rv=rv, perm=perm, valid=valid,
                     t=t, b=b, n_pad=int(n_pad))


def tile_endpoints(tile_ls, tile_lr, tile_su, tile_rv, t: int, bk: int):
    """Global (sender, receiver) ids of every slot, int32."""
    blk = torch.arange(tile_ls.shape[0], device=tile_ls.device) // bk
    gs = tile_su[blk] * t + tile_ls
    gr = tile_rv[blk] * t + tile_lr
    return gs.to(torch.int32), gr.to(torch.int32)


def score_head_tiles_plain(h, w1a, w1b, b1, w2, b2, tile_ls, tile_lr,
                           tile_su, tile_rv, t: int, bk: int,
                           drop: HeadDropout = None,
                           chunk: int = PLAIN_CHUNK):
    """Plain version over the split head: the slots' global ids, then the
    plain sampled head (ids past N read zero rows, as the TPU's padded h)."""
    gs, gr = tile_endpoints(tile_ls, tile_lr, tile_su, tile_rv, t, bk)
    return score_head_plain(h, w1a, w1b, b1, w2, b2, gs, gr, drop, chunk)


@torch.no_grad()
def score_head_tiles(h, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                     tile_ls, tile_lr, tile_su, tile_rv, *, t: int, bk: int,
                     drop_rate: float = 0.0, seed=0):
    """Score every tile-indexed edge slot. Returns (Ep,) f32 probabilities
    in TILE order (``Graph.tile_perm`` maps winners back). ``seed`` is an
    int or a (1,) int32 tensor on h's device."""
    ep = tile_ls.shape[0]
    if tile_lr.shape != (ep,) or ep % bk or tile_su.shape != (ep // bk,) \
            or tile_rv.shape != tile_su.shape:
        raise ValueError("score_head_tiles: tile index shapes do not match "
                         f"Ep={ep}, b={bk}")
    drop = HeadDropout.make(drop_rate, seed, h.device)
    h = h.detach().contiguous()
    w1a, w1b, b1, w2, b2 = split_head(h, fc1_kernel.detach(),
                                      fc1_bias.detach(), fc2_kernel.detach(),
                                      fc2_bias.detach())
    if h.device.type == "cpu":
        return score_head_tiles_plain(h, w1a, w1b, b1, w2, b2, tile_ls,
                                      tile_lr, tile_su, tile_rv, t, bk, drop)
    _check_kernel_inputs("score_head_tiles", h, w1a, w1b, b1, w2, b2, drop,
                         tile_ls, tile_lr, tile_su, tile_rv)
    n, f = h.shape
    out = torch.empty(ep, dtype=torch.float32, device=h.device)
    if ep == 0:
        return out
    hk, bf16, pitch, wpack = kernel_operands(h, w1a, w1b)
    _build.call("score_head_tiles", "sgs_score_head_tiles", h.device,
                hk.data_ptr(), bf16, pitch, w1a.data_ptr(), w1b.data_ptr(),
                None if wpack is None else wpack.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), tile_ls.data_ptr(),
                tile_lr.data_ptr(), tile_su.data_ptr(), tile_rv.data_ptr(),
                int(t), int(bk), drop.seed.data_ptr(), drop.thresh,
                drop.scale, out.data_ptr(), ep, n, f, w1a.shape[1])
    return out

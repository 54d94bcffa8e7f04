"""Dropout for the port: the score head's counter-based mask and the GCN
layers' generator-driven dropout.

**The score head's mask** (K3, K5 and K6 in ``csrc/``, and their plain
versions here). Hidden unit k of edge slot e is kept when

    hash32(seed, e * K + k) >= floor(rate * 2**32)

and a kept unit is scaled by 1 / (1 - rate). ``hash32`` is murmur3's 32-bit
finalizer applied twice (``csrc/common.cuh``); ``hash32_plain`` is its
bit-exact twin in int64 torch arithmetic. e is the slot's position in the
call's (q,) or (Ep,) list, never a block index, so neither a kernel's block
size nor the ``sorted_side`` endpoint swap changes the mask, the backward
regenerates the forward's mask from the seed, and a plain version
reproduces a kernel's mask bit for bit. The TPU kernels drew their bits
from ``pltpu.prng_random_bits`` per grid block, which no other machine can
reproduce: the JAX comparison runs without dropout, and the mask is tested
by its distribution. The seed is a (1,) int32 tensor on the tensors'
device, read by the kernel, so neither drawing it nor making it from an
int waits for the card.

**Layer dropout** (``dropout``): flax ``nn.Dropout``'s formula, with the
keep draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash32_plain(seed, counters):
    """``hash32`` of ``csrc/common.cuh`` as int64 values in [0, 2**32):
    ``seed`` an int or int tensor, ``counters`` an int64 tensor >= 0."""
    counters = counters.long()
    seed = torch.as_tensor(seed, device=counters.device).long() & _M32
    inner = _fmix32(seed ^ 0x243F6A88 ^ _mul32(counters >> 32, 0x9E3779B9))
    return _fmix32((counters & _M32) ^ inner)


def hash32(seed, counters):
    """``hash32`` of every counter: the plain version for CPU tensors, the
    ``sgs_dropout_bits`` kernel for CUDA ones (``seed`` a (1,) int32
    tensor on the same card)."""
    if counters.device.type == "cpu":
        return hash32_plain(seed, counters)
    seed = seed.reshape(1).to(torch.int32).contiguous()
    counters = counters.long().contiguous()
    _build.check_cuda("dropout_bits", counters, seed)
    out = torch.empty_like(counters)
    if counters.numel():
        _build.call("dropout_bits", "sgs_dropout_bits", counters.device,
                    seed.data_ptr(), counters.data_ptr(), out.data_ptr(),
                    counters.numel())
    return out


class HeadDropout(NamedTuple):
    """The score head's dropout for one call."""
    seed: torch.Tensor   # (1,) int32 on the tensors' device
    thresh: int          # keep a unit when its hash >= thresh; 0: keep all
    scale: float         # factor of a kept unit, 1 / (1 - rate)

    @staticmethod
    def make(rate: float, seed, device) -> "HeadDropout":
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"drop_rate={rate} not in [0, 1)")
        if isinstance(seed, torch.Tensor):
            seed_t = seed.reshape(1).to(device=device, dtype=torch.int32)
        else:
            # a fill on the device: a host copy would wait for the stream
            seed_t = torch.full((1,), int(seed), dtype=torch.int32,
                                device=device)
        # the JAX kernels' constants (score_sampled.py:_dropout_consts)
        thresh = min(int(rate * (1 << 32)), (1 << 32) - 1)
        return HeadDropout(seed_t, thresh, 1.0 / (1.0 - rate))


def keep_mask(drop: HeadDropout, e0: int, n_edges: int, hidden: int):
    """(n_edges, hidden) bool: the kept units of slots [e0, e0+n_edges)."""
    dev = drop.seed.device
    e = torch.arange(e0, e0 + n_edges, device=dev, dtype=torch.int64)
    k = torch.arange(hidden, device=dev, dtype=torch.int64)
    return hash32_plain(drop.seed, e[:, None] * hidden + k) >= drop.thresh


def dropout_keep(shape, rate: float, generator, device):
    """The kept entries of a ``shape`` dropout: one uniform draw each from
    ``generator``, kept below 1 - rate."""
    u = torch.rand(shape, generator=generator, device=device)
    return u < 1.0 - rate


def apply_keep(x, keep, rate: float):
    """Kept entries of ``x`` scaled by 1 / (1 - rate), the others 0."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


def dropout(x, rate: float, generator, training: bool = True):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    entries by 1 / (1 - rate); the keep draws come from ``generator``."""
    if rate == 0.0 or not training:
        return x
    return apply_keep(x, dropout_keep(x.shape, rate, generator, x.device),
                      rate)

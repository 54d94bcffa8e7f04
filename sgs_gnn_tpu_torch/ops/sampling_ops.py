"""Weighted sampling without replacement (port of ``ops/sampling_ops.py``).

Gumbel-top-k: adding i.i.d. Gumbel noise to log-probabilities and taking
the top q indices draws a without-replacement sample from the same
distribution as sequential proportional draws (the reference's
``torch.multinomial(p, q, replacement=False)``). The selection is an exact
``torch.topk``; the JAX package's ``approx_max_k`` and bf16 keys are TPU
choices and are not ported. Noise comes from an explicit
``torch.Generator`` on the tensors' device, so it is a different stream
from ``jax.random``: compare draws by distribution.
"""
from __future__ import annotations

import torch

_TINY = 1e-30


def _uniform(generator, shape, device):
    # (0, 1): the Gumbel transform needs u > 0
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


def _select_topk(keys, q: int):
    if q > keys.shape[0]:
        raise ValueError(f"cannot sample q={q} of {keys.shape[0]} items")
    return torch.topk(keys, q).indices.to(torch.int32)


def gumbel_topk(generator, probs, q: int, mask=None):
    """q int32 indices sampled without replacement proportionally to
    ``probs`` (need not be normalised); ``mask=False`` entries are never
    sampled."""
    logp = torch.log(torch.clamp(probs.float(), min=_TINY))
    gumbel = -torch.log(-torch.log(_uniform(generator, probs.shape,
                                            probs.device)))
    keys = logp + gumbel
    if mask is not None:
        keys = torch.where(mask, keys, float("-inf"))
    return _select_topk(keys, q)


def uniform_topk(generator, num_items: int, q: int, mask=None,
                 device="cuda"):
    """Uniform q-subset of ``num_items`` without replacement."""
    keys = _uniform(generator, (num_items,), device)
    if mask is not None:
        keys = torch.where(mask, keys, float("-inf"))
    return _select_topk(keys, q)

"""Weighted sampling without replacement (port of ``ops/sampling_ops.py``).

Gumbel-top-k: adding i.i.d. Gumbel noise to log-probabilities and taking
the top q indices draws a without-replacement sample from the same
distribution as sequential proportional draws (the reference's
``torch.multinomial(p, q, replacement=False)``). The selection is exact;
the JAX package's ``approx_max_k`` and bf16 keys are TPU choices and are
not ported. Noise comes from an explicit ``torch.Generator`` on the
tensors' device, one ``torch.rand`` of shape (E,) per draw, so it is a
different stream from ``jax.random``: compare draws by distribution.

:func:`topq_ordered` returns the winners in ascending id (the JAX package's
``lax.top_k`` returns them by descending key; no caller reads that order).
Ties at the q-th largest key go to the lowest ids. On a CUDA tensor it
runs ``csrc/topq.cu``, which forms the keys from the uniforms itself and
selects by a radix threshold select and an in-order compaction, with no
host read; on a CPU tensor its plain version, under the same contract.
``_build.ROUTES[("topq", "gumbel" | "uniform")]`` counts the draws by key
formula on either device; the kernel also counts, on the card, the draws
whose threshold had more equal keys than it took and the tied ids it took
(:func:`topq_ties`).
"""
from __future__ import annotations

import torch

from . import _build

_TINY = 1e-30
_U_MIN = torch.finfo(torch.float32).tiny


def log_weights(probs):
    """The Gumbel draw's per-distribution term, ``log(max(p, 1e-30))`` in
    f32: compute it once for draws from one distribution."""
    return torch.log(torch.clamp(probs.float(), min=_TINY))


def draw_keys(u, logw=None, mask=None):
    """The keys of a draw from uniforms ``u`` (f32): Gumbel keys
    ``logw - log(-log(max(u, tiny)))`` or, without ``logw``, uniform keys
    ``max(u, tiny)``; -inf where ``mask`` is False."""
    u = torch.clamp(u, min=_U_MIN)
    keys = u if logw is None else logw - torch.log(-torch.log(u))
    if mask is not None:
        keys = torch.where(mask, keys, float("-inf"))
    return keys


def topq_ordered_plain(keys, q: int):
    """q int32 ids of the largest ``keys``, ascending: every id whose key is
    above the q-th largest key T, then the lowest ids whose key equals T
    until there are q."""
    t = torch.topk(keys, q, sorted=False).values.min()
    take = keys > t
    tied = torch.nonzero(keys == t).flatten()
    take[tied[:q - int(take.sum())]] = True
    return torch.nonzero(take).flatten().to(torch.int32)


# {card index: (2,) int64 on the card}: draws that broke a tie at the
# threshold, tied ids they took
_ties: dict = {}


def _ties_buffer(device):
    buf = _ties.get(device.index)
    if buf is None:
        buf = _ties[device.index] = torch.zeros(2, dtype=torch.int64,
                                                device=device)
    return buf


def reset_topq_ties() -> None:
    """Sets the card's tie counts to 0 (a device memset; nothing waits)."""
    for buf in _ties.values():
        buf.zero_()


def topq_ties() -> dict:
    """{"draws": n, "ids": n}: the kernel's draws since the last reset whose
    threshold key had more entries than the draw took, and the entries
    equal to it they took, summed over the cards. Reads the card (the host
    waits for it)."""
    draws = ids = 0
    for buf in _ties.values():
        d, i = buf.tolist()
        draws, ids = draws + d, ids + i
    return {"draws": draws, "ids": ids}


def _topq_cuda(u, q: int, logw, mask):
    """The kernel's ids and its scratch (whose tail holds the keys' order-
    preserving images: tests read them)."""
    tensors = [t for t in (u, logw, mask) if t is not None]
    _build.check_cuda("topq", *tensors)
    n = u.shape[0]
    if any(t.shape != (n,) for t in tensors):
        raise ValueError("topq: shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if u.dtype != torch.float32 or (logw is not None
                                    and logw.dtype != torch.float32):
        raise TypeError("topq: u and logw must be float32")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"topq: mask dtype {mask.dtype}, want bool")
    out = torch.empty(q, dtype=torch.int32, device=u.device)
    words = _build.library().sgs_topq_scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int32, device=u.device)
    _build.call("topq", "sgs_topq", u.device,
                None if logw is None else logw.data_ptr(), u.data_ptr(),
                None if mask is None else mask.data_ptr(), n, q,
                scratch.data_ptr(), words, _ties_buffer(u.device).data_ptr(),
                out.data_ptr())
    return out, scratch


def topq_ordered(u, q: int, logw=None, mask=None):
    """q int32 ids of the largest keys of a draw (:func:`draw_keys`), in
    ascending id; ties at the q-th largest key go to the lowest ids.
    1 <= q <= E."""
    n = u.shape[0]
    if not 1 <= q <= n:
        raise ValueError(f"cannot sample q={q} of {n} items")
    _build.ROUTES["topq", "gumbel" if logw is not None else "uniform"] += 1
    if u.device.type == "cpu":
        return topq_ordered_plain(draw_keys(u, logw, mask), q)
    return _topq_cuda(u, q, logw, mask)[0]


def _uniform(generator, n: int, device):
    return torch.rand((n,), generator=generator, device=device,
                      dtype=torch.float32)


def gumbel_topk_logw(generator, logw, q: int, mask=None):
    """:func:`gumbel_topk` from the distribution's :func:`log_weights`."""
    return topq_ordered(_uniform(generator, logw.shape[0], logw.device), q,
                        logw=logw, mask=mask)


def gumbel_topk(generator, probs, q: int, mask=None):
    """q int32 indices, ascending, sampled without replacement
    proportionally to ``probs`` (need not be normalised); ``mask=False``
    entries are never sampled while q valid entries remain."""
    return gumbel_topk_logw(generator, log_weights(probs), q, mask)


def uniform_topk(generator, num_items: int, q: int, mask=None,
                 device="cuda"):
    """Uniform q-subset of ``num_items`` without replacement, ascending."""
    return topq_ordered(_uniform(generator, num_items, device), q,
                        mask=mask)

"""Losses and on-device metrics (port of ``train/losses.py``).

Everything stays on the device: micro-F1 over single-label predictions is
masked accuracy, and the reg1 gate ("more than one positive label") is a
``torch.where`` on a device scalar, so no loss reads a value back to the
host.
"""
from __future__ import annotations

import torch

from ..ops.edge_gather import gather_rows


def masked_cross_entropy(logits, labels, mask):
    """Mean CE over masked nodes (reference ``criterion(out[mask],
    y[mask])``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    m = mask.to(nll.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def micro_f1(logits, labels, mask):
    """Micro-averaged F1 == accuracy for single-label classification."""
    preds = torch.argmax(logits, dim=-1)
    hit = (preds == labels.long()).float()
    m = mask.float()
    return torch.sum(hit * m) / torch.clamp(torch.sum(m), min=1.0)


class _BceClamped(torch.autograd.Function):
    """Binary cross-entropy with torch ``F.binary_cross_entropy``'s
    saturation semantics, as the JAX custom VJP has them: the forward
    clamps each log term at -100, the backward divides by
    max(p(1-p), 1e-12), so a sigmoid saturated to exactly 0 or 1
    contributes a finite 100 with a large but finite gradient."""

    @staticmethod
    def forward(ctx, p, labels):
        ctx.save_for_backward(p, labels)
        log_p = torch.clamp(torch.log(p), min=-100.0)
        log_1p = torch.clamp(torch.log(1.0 - p), min=-100.0)
        return -(labels * log_p + (1.0 - labels) * log_1p)

    @staticmethod
    def backward(ctx, g):
        p, labels = ctx.saved_tensors
        dp = g * (p - labels) / torch.clamp(p * (1.0 - p), min=1e-12)
        return dp, None


def _assortative(edge_probs, both_train, same):
    labels = same.to(edge_probs.dtype)
    bce = _BceClamped.apply(edge_probs, labels)
    valid = both_train.to(edge_probs.dtype)
    mean_bce = torch.sum(bce * valid) / torch.clamp(torch.sum(valid), min=1.0)
    n_pos = torch.sum(labels * valid)
    return torch.where(n_pos > 1.0, mean_bce, 0.0)


def assortative_bce(edge_probs, sampled_senders, sampled_receivers, y,
                    train_mask):
    """reg1: homophily BCE over sampled train-train edges (label 1 when the
    endpoints share a class), zero unless more than one label is
    positive."""
    s = sampled_senders.long()
    r = sampled_receivers.long()
    return _assortative(edge_probs, train_mask[s] & train_mask[r],
                        y[s] == y[r])


def assortative_bce_flags(edge_probs, flags):
    """reg1 from the packed edge flags (``Graph.edge_aux`` column 2: bit0 =
    both endpoints train, bit1 = same label)."""
    return _assortative(edge_probs, (flags & 1) > 0, ((flags >> 1) & 1) > 0)


def consistency_loss(edge_probs, sampled_senders, sampled_receivers,
                     node_embeddings, valid=None):
    """reg2: MSE between sampled-edge probabilities and the cosine
    similarity of the endpoints' output embeddings (denominator clamped at
    1e-8, squared norms at 1e-16). The two endpoint gathers go through
    ``gather_rows``, whose backward is K1 on the card. ``valid`` excludes
    padding selections from the mean."""
    src = gather_rows(node_embeddings, sampled_senders)
    dst = gather_rows(node_embeddings, sampled_receivers)
    num = torch.sum(src * dst, dim=-1)

    def safe_norm(v):
        return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-16))

    denom = torch.clamp(safe_norm(src), min=1e-8) * \
        torch.clamp(safe_norm(dst), min=1e-8)
    sq = (edge_probs - num / denom) ** 2
    if valid is None:
        return torch.mean(sq)
    m = valid.to(sq.dtype)
    return torch.sum(sq * m) / torch.clamp(torch.sum(m), min=1.0)

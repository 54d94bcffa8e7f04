"""Edge-score head over dynamic edge indices: the port of
``ops/score_sampled.py`` (forward).

``score_head_sampled`` keeps the JAX argument layout: ``h`` (N, F) node
embeddings, ``fc1_kernel`` the (2F, K) concat-layout kernel (in, out),
``fc1_bias`` (K,), ``fc2_kernel`` (K, 1), ``fc2_bias`` (1,), ``senders`` and
``receivers`` (q,) int32. It returns (q,) float32 probabilities

    sigmoid(fc2(relu(fc1([h_u*h_v || h_u-h_v]))))

with fc1 split into its product half W1a = fc1_kernel[:F] and difference
half W1b = fc1_kernel[F:], cast to h's dtype, so no (q, 2F) concat is
formed. The product and difference are rounded to h's dtype, the sums run
in f32.

On a CUDA tensor the wrapper launches ``csrc/score_sampled.cu``, which
replaces ``score_sampled.py:_make_fwd_kernel`` (the full, unbanded kernel
behind ``_fwd_call``): the TPU kernel selected endpoint rows with one-hot
matmuls, this one gathers them from the L2-resident table. It is bound by
operations (2*2F*K per edge); the first version runs on CUDA cores, an order
of magnitude above that bound (see the source). On the CPU the plain
version runs.

Dropout (``drop_rate > 0``) and the gathered-row residuals for the backward
come with the training slice; the wrapper raises on ``drop_rate > 0``.
"""
from __future__ import annotations

import torch

from . import _build


def split_head(h, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias):
    """(W1a, W1b) in h's dtype and (b1, w2, b2) as flat float32, from the
    JAX-layout head parameters."""
    f = h.shape[1]
    if fc1_kernel.shape[0] != 2 * f:
        raise ValueError(f"fc1_kernel {tuple(fc1_kernel.shape)} does not "
                         f"match 2F = {2 * f}")
    w1a = fc1_kernel[:f].to(h.dtype).contiguous()
    w1b = fc1_kernel[f:].to(h.dtype).contiguous()
    b1 = fc1_bias.reshape(-1).float().contiguous()
    w2 = fc2_kernel.reshape(-1).float().contiguous()
    b2 = fc2_bias.reshape(-1).float().contiguous()
    if not (b1.shape[0] == w2.shape[0] == w1a.shape[1]) or b2.shape[0] != 1:
        raise ValueError("score head: fc1/fc2 shapes do not match")
    return w1a, w1b, b1, w2, b2


def score_head_plain(h, w1a, w1b, b1, w2, b2, senders, receivers):
    """Plain version over the split head: gather + two f32 matmuls."""
    hu = h[senders.long()]
    hv = h[receivers.long()]
    z = (hu * hv).float() @ w1a.float() + (hu - hv).float() @ w1b.float() + b1
    return torch.sigmoid(torch.relu(z) @ w2 + b2)


def score_head_sampled(h, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                       senders, receivers, drop_rate: float = 0.0, seed=0):
    """(q,) float32 edge probabilities; see the module docstring."""
    if drop_rate > 0.0:
        raise NotImplementedError(
            "score_head_sampled: dropout comes with the training slice "
            "(its kernel regenerates the mask in the backward)")
    if senders.shape != receivers.shape or senders.dim() != 1:
        raise ValueError("score_head_sampled: senders/receivers must be (q,)")
    w1a, w1b, b1, w2, b2 = split_head(h, fc1_kernel, fc1_bias, fc2_kernel,
                                       fc2_bias)
    if h.device.type == "cpu":
        return score_head_plain(h, w1a, w1b, b1, w2, b2, senders, receivers)
    _build.check_cuda("score_head_sampled", h, w1a, w1b, b1, w2, b2, senders,
                      receivers)
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"score_head_sampled: h dtype {h.dtype}")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError("score_head_sampled: senders/receivers must be int32")
    q = senders.shape[0]
    n, f = h.shape
    k = w1a.shape[1]
    out = torch.empty(q, dtype=torch.float32, device=h.device)
    if q == 0:
        return out
    _build.call("score_head_sampled", "sgs_score_head_fwd", h.device,
                h.data_ptr(), int(h.dtype == torch.bfloat16), w1a.data_ptr(),
                w1b.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                senders.data_ptr(), receivers.data_ptr(), out.data_ptr(),
                q, n, f, k)
    return out

"""Edge-score head over dynamic edge indices, forward and backward: the port
of ``ops/score_sampled.py``.

``score_head_sampled`` keeps the JAX argument layout: ``h`` (N, F) node
embeddings, ``fc1_kernel`` the (2F, K) concat-layout kernel (in, out),
``fc1_bias`` (K,), ``fc2_kernel`` (K, 1), ``fc2_bias`` (1,), ``senders`` and
``receivers`` (q,) int32. It returns (q,) float32 probabilities

    sigmoid(fc2(drop(relu(fc1([h_u*h_v || h_u-h_v])))))

with fc1 split into its product half W1a = fc1_kernel[:F] and difference
half W1b = fc1_kernel[F:], cast to h's dtype, so no (q, 2F) concat is
formed. The product and difference are rounded to h's dtype, the sums run
in f32. It is differentiable in h and the four head parameters through an
``autograd.Function`` whose backward regenerates the dropout mask from the
seed (``ops/dropout.py``); gradients come back in the inputs' types, as the
JAX custom VJP casts them (dh to h's dtype, dW1a/dW1b to W1a's).

On a CUDA tensor the forward launches K3 and the backward K5
(``csrc/score_sampled.cu``): K3 replaces ``_make_fwd_kernel`` behind both
``_fwd_call.call_full`` and ``call_banded`` (a Hopper gather reads rows
directly, so the band's cut of one-hot FLOPs has no counterpart), K5
replaces ``_make_bwd_kernel`` behind ``_bwd_call``. Both are bound by
operations. K3 dispatches on h's dtype (``kernel_operands``), in this
wrapper and in its C entry point: bf16 runs on the tensor cores
(``csrc/head_mma.cuh``, W1 packed by ``ops/head_mma.py``), f32 on CUDA
cores (``csrc/score_head.cuh``), since the tensor cores have no full-f32
product and TF32 would miss the f32 tolerance. Both count their launches
under the same name, and a kernel that fails raises. K5 dispatches the
same way (``bwd_operands``): bf16 runs three tensor-core kernels
(``csrc/head_bwd_mma.cuh``: the dz1 pass, the dh pass and the weight pass,
with W1 packed twice by ``ops/head_mma.py``, as the forward reads it and
transposed), f32 the two CUDA-core kernels of ``score_sampled.cu``; both
count one launch as ``score_head_bwd`` and their route in
``_build.ROUTES``. On the CPU the plain versions
run: ``score_head_plain`` and ``score_head_bwd_plain``, which follow the
kernels' cast points and mask bit for bit, edge chunk by edge chunk to
bound memory.

``sorted_side`` ('senders' | 'receivers' | '') names the endpoint array the
caller sorted. 'receivers' swaps the endpoints and negates W1b, as the JAX
op does ((hv-hu) @ -W1b == (hu-hv) @ W1b; the product half is symmetric),
so the first side is always the sorted one; K5 merges runs of equal ids on
the first side in its dh scatter. The probabilities and gradients do not
depend on it. A forward with a sorted side is the counterpart of
``call_banded`` (TPU kernel table row 4) and counts its launches as
``score_head_sampled_banded``; without one, as ``score_head_sampled``.
"""
from __future__ import annotations

import torch

from . import _build, head_mma
from .dropout import HeadDropout, keep_mask
from .scatter import rows_at, scatter_add_plain

SORTED_SIDES = ("", "senders", "receivers")
PLAIN_CHUNK = 65536      # edges per chunk of the plain versions
MAX_HIDDEN = 1024        # K5 sums db1/dw2 in 2K floats of shared memory


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


def _chunks(q: int, chunk: int):
    return range(0, q, max(int(chunk), 1))


def _first_layer(hu, hv, w1a, w1b, b1):
    prod = hu * hv
    diff = hu - hv
    z = prod.float() @ w1a.float() + diff.float() @ w1b.float() + b1
    return prod, diff, z


def _dropped(zr, drop, e0):
    """drop(zr) for slots e0.. and the keep mask (None without dropout)."""
    if drop is None or drop.thresh == 0:
        return zr, None
    keep = keep_mask(drop, e0, zr.shape[0], zr.shape[1])
    return torch.where(keep, zr * drop.scale, 0.0), keep


def score_head_plain(h, w1a, w1b, b1, w2, b2, senders, receivers,
                     drop: HeadDropout = None, chunk: int = PLAIN_CHUNK):
    """Plain version over the split head: gathers + two f32 matmuls, the
    dropout mask of ``ops/dropout.py``; chunked over edges."""
    out = []
    for e0 in _chunks(senders.shape[0], chunk):
        # ids outside [0, N) read zero rows, as in the kernels
        hu = rows_at(h, senders[e0:e0 + chunk], h.shape[0])
        hv = rows_at(h, receivers[e0:e0 + chunk], h.shape[0])
        _, _, z = _first_layer(hu, hv, w1a, w1b, b1)
        zd, _ = _dropped(torch.relu(z), drop, e0)
        out.append(torch.sigmoid(zd @ w2 + b2))
    if not out:
        return torch.empty(0, dtype=torch.float32, device=h.device)
    return torch.cat(out)


def score_head_bwd_plain(h, w1a, w1b, b1, w2, b2, senders, receivers, dp,
                         drop: HeadDropout = None,
                         chunk: int = PLAIN_CHUNK):
    """Plain VJP with the JAX kernel's cast points (score_sampled.py:237-
    261): returns f32 (dh, dW1a, dW1b, db1, dw2, db2)."""
    n, f = h.shape
    k = w1a.shape[1]
    dev = h.device
    dh = torch.zeros((n, f), dtype=torch.float32, device=dev)
    dw1a = torch.zeros((f, k), dtype=torch.float32, device=dev)
    dw1b = torch.zeros((f, k), dtype=torch.float32, device=dev)
    db1 = torch.zeros(k, dtype=torch.float32, device=dev)
    dw2 = torch.zeros(k, dtype=torch.float32, device=dev)
    db2 = torch.zeros(1, dtype=torch.float32, device=dev)
    for e0 in _chunks(senders.shape[0], chunk):
        s = senders[e0:e0 + chunk]
        r = receivers[e0:e0 + chunk]
        hu, hv = rows_at(h, s, n), rows_at(h, r, n)
        prod, diff, z1 = _first_layer(hu, hv, w1a, w1b, b1)
        zd, keep = _dropped(torch.relu(z1), drop, e0)
        p = torch.sigmoid(zd @ w2 + b2)
        dlogit = dp[e0:e0 + chunk].float() * p * (1.0 - p)
        db2 += dlogit.sum()
        dw2 += (zd * dlogit[:, None]).sum(0)
        dzr = dlogit[:, None] * w2
        if keep is not None:
            dzr = torch.where(keep, dzr * drop.scale, 0.0)
        dz1 = torch.where(z1 > 0.0, dzr, 0.0)
        db1 += dz1.sum(0)
        dz1c = dz1.to(h.dtype).float()
        dw1a += prod.float().t() @ dz1c
        dw1b += diff.float().t() @ dz1c
        dprod = dz1c @ w1a.float().t()
        ddiff = dz1c @ w1b.float().t()
        dhu = (dprod * hv.float() + ddiff).to(h.dtype)
        dhv = (dprod * hu.float() - ddiff).to(h.dtype)
        dh += scatter_add_plain(dhu, s, n)
        dh += scatter_add_plain(dhv, r, n)
    return dh, dw1a, dw1b, db1, dw2, db2


def _check_kernel_inputs(name, h, w1a, w1b, b1, w2, b2, drop, *ids):
    _build.check_cuda(name, h, w1a, w1b, b1, w2, b2, drop.seed, *ids)
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: h dtype {h.dtype}")
    if any(i.dtype != torch.int32 for i in ids):
        raise TypeError(f"{name}: ids must be int32")


def kernel_operands(h, w1a, w1b):
    """The forward kernels' operands by h's dtype: (h, h_bf16, pitch,
    wpack). bf16 takes the tensor cores: h with 16-byte rows and W1 packed
    as their shared-memory image (``ops/head_mma.py``); f32 takes the CUDA
    cores, which read h, W1a and W1b as they are (wpack None)."""
    if h.dtype == torch.bfloat16:
        h16, pitch = head_mma.head_rows(h)
        return h16, 1, pitch, head_mma.pack_head_weights(w1a, w1b)
    return h, 0, h.shape[1], None


def _head_fwd(h, w1a, w1b, b1, w2, b2, sid, rid, drop, banded=False):
    if h.device.type == "cpu":
        return score_head_plain(h, w1a, w1b, b1, w2, b2, sid, rid, drop)
    _check_kernel_inputs("score_head_sampled", h, w1a, w1b, b1, w2, b2,
                         drop, sid, rid)
    q = sid.shape[0]
    n, f = h.shape
    out = torch.empty(q, dtype=torch.float32, device=h.device)
    if q == 0:
        return out
    hk, bf16, pitch, wpack = kernel_operands(h, w1a, w1b)
    kernel = "score_head_sampled_banded" if banded else "score_head_sampled"
    _build.call(kernel, "sgs_score_head_fwd", h.device,
                hk.data_ptr(), bf16, pitch, w1a.data_ptr(), w1b.data_ptr(),
                None if wpack is None else wpack.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), sid.data_ptr(), rid.data_ptr(),
                drop.seed.data_ptr(), drop.thresh, drop.scale,
                out.data_ptr(), q, n, f, w1a.shape[1])
    return out


def bwd_operands(h, w1a, w1b, q: int):
    """K5's operands by h's dtype: (h, h_bf16, pitch, wpack, wpack_t, dz1
    scratch). bf16 takes the tensor cores: the forward's operands, W1
    packed transposed for the dh pass and the dz1 image of every edge
    tile; f32 takes the CUDA cores, which read h, W1a and W1b as they are
    and write dz1 as a (q, K) array."""
    hk, bf16, pitch, wpack = kernel_operands(h, w1a, w1b)
    k = w1a.shape[1]
    if bf16:
        return (hk, bf16, pitch, wpack, head_mma.pack_head_weights_t(
            w1a, w1b), torch.empty(head_mma.dz1_numel(q, k), dtype=h.dtype,
                                   device=h.device))
    return hk, bf16, pitch, None, None, torch.empty(
        (q, k), dtype=h.dtype, device=h.device)


def _head_bwd(h, w1a, w1b, b1, w2, b2, sid, rid, dp, drop):
    if h.device.type == "cpu":
        return score_head_bwd_plain(h, w1a, w1b, b1, w2, b2, sid, rid, dp,
                                    drop)
    dp = dp.float().contiguous()
    _check_kernel_inputs("score_head_bwd", h, w1a, w1b, b1, w2, b2, drop,
                         sid, rid)
    _build.check_cuda("score_head_bwd", h, dp)
    q = sid.shape[0]
    n, f = h.shape
    k = w1a.shape[1]
    if k > MAX_HIDDEN:
        raise ValueError(f"score_head_bwd: K={k} above {MAX_HIDDEN}")
    dev = h.device
    dh = torch.zeros((n, f), dtype=torch.float32, device=dev)
    dw1a = torch.zeros((f, k), dtype=torch.float32, device=dev)
    dw1b = torch.zeros((f, k), dtype=torch.float32, device=dev)
    db1 = torch.zeros(k, dtype=torch.float32, device=dev)
    dw2 = torch.zeros(k, dtype=torch.float32, device=dev)
    db2 = torch.zeros(1, dtype=torch.float32, device=dev)
    if q == 0:
        return dh, dw1a, dw1b, db1, dw2, db2
    hk, bf16, pitch, wpack, wpack_t, dz1 = bwd_operands(h, w1a, w1b, q)
    _build.call("score_head_bwd", "sgs_score_head_bwd", dev,
                hk.data_ptr(), bf16, pitch, w1a.data_ptr(), w1b.data_ptr(),
                None if wpack is None else wpack.data_ptr(),
                None if wpack_t is None else wpack_t.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), sid.data_ptr(),
                rid.data_ptr(), dp.data_ptr(), drop.seed.data_ptr(),
                drop.thresh, drop.scale, dz1.data_ptr(), dh.data_ptr(),
                dw1a.data_ptr(), dw1b.data_ptr(), db1.data_ptr(),
                dw2.data_ptr(), db2.data_ptr(), q, n, f, k,
                route="tensor_cores" if bf16 else "cuda_cores")
    return dh, dw1a, dw1b, db1, dw2, db2


class _ScoreHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w1a, w1b, b1, w2, b2, sid, rid, drop, banded):
        ctx.save_for_backward(h, w1a, w1b, b1, w2, b2, sid, rid)
        ctx.drop = drop
        return _head_fwd(h, w1a, w1b, b1, w2, b2, sid, rid, drop, banded)

    @staticmethod
    def backward(ctx, dp):
        h, w1a, w1b, b1, w2, b2, sid, rid = ctx.saved_tensors
        dh, dw1a, dw1b, db1, dw2, db2 = _head_bwd(
            h, w1a, w1b, b1, w2, b2, sid, rid, dp, ctx.drop)
        return (dh.to(h.dtype), dw1a.to(w1a.dtype), dw1b.to(w1b.dtype), db1,
                dw2, db2, None, None, None, None)


def score_head_sampled(h, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                       senders, receivers, drop_rate: float = 0.0, seed=0,
                       sorted_side: str = ""):
    """(q,) float32 edge probabilities; see the module docstring. ``seed``
    is an int or a (1,) int32 tensor on h's device (no host sync)."""
    if senders.shape != receivers.shape or senders.dim() != 1:
        raise ValueError("score_head_sampled: senders/receivers must be (q,)")
    if sorted_side not in SORTED_SIDES:
        raise ValueError(f"sorted_side={sorted_side!r} not in "
                         f"{SORTED_SIDES}")
    drop = HeadDropout.make(drop_rate, seed, h.device)
    w1a, w1b, b1, w2, b2 = split_head(h, fc1_kernel, fc1_bias, fc2_kernel,
                                      fc2_bias)
    if sorted_side == "receivers":
        senders, receivers = receivers, senders
        w1b = -w1b
    return _ScoreHead.apply(h.contiguous(), w1a, w1b, b1, w2, b2,
                            senders.contiguous(), receivers.contiguous(),
                            drop, bool(sorted_side))

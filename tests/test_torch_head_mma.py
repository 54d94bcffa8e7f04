"""What surrounds the tensor-core forward head (``csrc/head_mma.cuh``), on
the CPU: the packed weight image its B descriptors read, h's 16-byte rows,
the dtype dispatch, and a plain function that follows the kernel's schedule
(feature chunks of 64 feeding both halves from the packed image, K tiles of
at most 256 real columns, dropout counters over the real columns only).

The schedule is held to ``score_head_plain`` (same mask, f32 sums in
another order: atol 1e-5 on probabilities) with dropout off and on, and,
without dropout, to the JAX package's Pallas kernel in interpret mode (f32;
the TPU's in-kernel dropout bits cannot be reproduced elsewhere, see
``tests/test_torch_tiles.py``). Ids outside [0, N) read zero rows on every
side.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgs_gnn_tpu.ops.score_sampled import (
    score_head_sampled as jax_score_head_sampled)

from sgs_gnn_tpu_torch.ops import head_mma as hm
from sgs_gnn_tpu_torch.ops import score_sampled as ss
from sgs_gnn_tpu_torch.ops.dropout import HeadDropout

SHAPES = [(3, 1), (33, 7), (256, 300)]     # (F, K): ragged chunks and tiles


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(f, k, n=40, q=300, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, f)).astype(np.float32)
    head = tuple(a.astype(np.float32) for a in (
        rng.normal(size=(2 * f, k)) / np.sqrt(2 * f),
        rng.normal(size=(k,)) * 0.1, rng.normal(size=(k, 1)) / np.sqrt(k),
        rng.normal(size=(1,)) * 0.1))
    s = rng.integers(-1, n + 2, q).astype(np.int32)
    r = rng.integers(-1, n + 2, q).astype(np.int32)
    return h, head, s, r


def _schedule(h, head, s, r, drop):
    w1a, w1b, b1, w2, b2 = ss.split_head(h, *head)
    return hm.score_head_mma_plain(h, hm.pack_head_weights(w1a, w1b), b1,
                                   w2, b2, s, r, drop)


@pytest.mark.parametrize("f", [3, 33, 256])
@pytest.mark.parametrize("k", [1, 7, 300])
def test_packed_image_unpacks_to_w1_with_zero_padding(f, k):
    rng = np.random.default_rng(f * 1000 + k)
    w1a = _t(rng.normal(size=(f, k)).astype(np.float32)).to(torch.bfloat16)
    w1b = _t(rng.normal(size=(f, k)).astype(np.float32)).to(torch.bfloat16)
    packed = hm.pack_head_weights(w1a, w1b)
    fp, kp = hm.padded_dims(f, k)
    assert fp % hm.CHUNK == 0 and kp % hm.N_TILE == 0
    assert packed.dtype == torch.bfloat16 and packed.shape == (2 * fp * kp,)
    full = hm.unpack_head_weights(packed, f, k)
    assert torch.equal(full[0, :f, :k], w1a)
    assert torch.equal(full[1, :f, :k], w1b)
    pad = torch.ones(full.shape, dtype=torch.bool)
    pad[:, :f, :k] = False
    assert not bool(full[pad].any())
    # element (n, k) of W1b's slice of K tile 0, chunk 0 sits in core matrix
    # (n // 8, k // 8) of the second half, as the descriptors read it
    for kk, n in ((0, 0), (min(f, 64) - 1, min(k, 256) - 1)):
        at = (hm.N_TILE * hm.CHUNK + (n // 8) * 512 + (kk // 8) * 64
              + (n % 8) * 8 + kk % 8)
        assert packed[at] == w1b[kk, n]
    # every chunk slice the schedule reads is the matching block of W1
    for t in range(kp // hm.N_TILE):
        for c in range(fp // hm.CHUNK):
            for half in (0, 1):
                assert torch.equal(
                    hm.chunk_weights(packed, f, k, t, c, half),
                    full[half, c * hm.CHUNK:(c + 1) * hm.CHUNK,
                         t * hm.N_TILE:(t + 1) * hm.N_TILE])


@pytest.mark.parametrize("f,k", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop_rate", [0.0, 0.3])
def test_schedule_matches_plain_head(f, k, dtype, drop_rate):
    h, head, s, r = _case(f, k)
    th = _t(h).to(dtype)
    thead = [_t(a) for a in head]
    drop = HeadDropout.make(drop_rate, 17, "cpu")
    want = ss.score_head_plain(th, *ss.split_head(th, *thead), _t(s), _t(r),
                               drop)
    got = _schedule(th, thead, _t(s), _t(r), drop)
    assert got.dtype == torch.float32 and got.shape == (s.shape[0],)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if drop_rate:      # the mask is on: some units of every row dropped
        nodrop = _schedule(th, thead, _t(s), _t(r), None)
        assert not torch.allclose(got, nodrop)


@pytest.mark.parametrize("f,k", SHAPES)
def test_schedule_matches_jax_pallas(f, k):
    h, head, s, r = _case(f, k, q=77)
    # the JAX kernel reads ids in [0, N): clip them on both sides
    s, r = np.clip(s, 0, h.shape[0] - 1), np.clip(r, 0, h.shape[0] - 1)
    pallas = jax_score_head_sampled(
        *[jnp.asarray(a) for a in (h, *head, s, r)], block=64,
        interpret=True)
    got = _schedule(_t(h), [_t(a) for a in head], _t(s), _t(r), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("f", [3, 8, 33])
def test_head_rows_pad_to_16_bytes(f):
    h = torch.randn(5, f).to(torch.bfloat16)
    rows, pitch = hm.head_rows(h)
    assert pitch % hm.ROW_ALIGN == 0 and pitch - f < hm.ROW_ALIGN
    assert rows.shape == (5, pitch)
    assert torch.equal(rows[:, :f], h)
    assert not bool(rows[:, f:].any())
    assert (rows is h) == (pitch == f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_operands_dispatch_on_dtype(dtype):
    f, k = 33, 7
    h = torch.randn(6, f).to(dtype)
    w1a, w1b = torch.randn(f, k).to(dtype), torch.randn(f, k).to(dtype)
    hk, bf16, pitch, wpack = ss.kernel_operands(h, w1a, w1b)
    if dtype == torch.bfloat16:       # the tensor cores' operands
        assert bf16 == 1 and pitch == 40 and hk.shape == (6, 40)
        assert torch.equal(wpack, hm.pack_head_weights(w1a, w1b))
    else:                             # the CUDA cores read h and W1 as is
        assert bf16 == 0 and pitch == f and hk is h and wpack is None

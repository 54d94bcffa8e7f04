"""What surrounds the tensor-core backward of the score head
(``csrc/head_bwd_mma.cuh``, the bf16 route of K5), on the CPU: the
transposed weight image the dh pass's B descriptors read, the dz1 scratch
image that the dh pass reads as a K-major A operand and the weight pass as
an MN-major B operand, the weight pass's edge splits, and a plain function
that follows the three kernels' schedules (``score_head_bwd_mma_plain``).

The schedule is held to ``score_head_bwd_plain`` with dropout off and on,
both sorted sides, ids in [-1, N+2). In f32 only the order of f32 sums
separates them: 1e-5 of max|plain| per output, plus q * 2^-24 for sums
over the q edges whose terms (|dlogit| < 1) cancel, as db2's do. In bf16
that order can also move the f32 value before a cast to bf16 (dz1, dh_u /
dh_v) across a rounding boundary, one bf16 ulp (2^-7 of the term) apart:
per element 2^-6 of |plain| + 1e-3 of max|plain|, and 1e-3 of max|plain|
per output.
Without dropout it is held to the VJP of the JAX package's Pallas kernel
in interpret mode (f32, clipped ids: the JAX kernel reads ids in [0, N)),
at rtol 1e-4 and 1e-5 of max|JAX| (f32 sums in another order, as
``tests/test_torch_tiles.py`` holds the plain VJP).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.ops.score_sampled import (
    score_head_sampled as jax_score_head_sampled)

from sgs_gnn_tpu_torch.ops import head_mma as hm
from sgs_gnn_tpu_torch.ops import score_sampled as ss
from sgs_gnn_tpu_torch.ops.dropout import HeadDropout

SHAPES = [(3, 1), (33, 7), (256, 300)]     # (F, K): ragged chunks and tiles
NAMES = ("dh", "dW1a", "dW1b", "db1", "dw2", "db2")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The schedules run many small matmuls: one torch thread each keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    dp = rng.normal(size=q).astype(np.float32)
    return h, head, s, r, dp


def _schedule(h, split, s, r, dp, drop, sms=132):
    w1a, w1b, b1, w2, b2 = split
    return hm.score_head_bwd_mma_plain(
        h, hm.pack_head_weights(w1a, w1b), hm.pack_head_weights_t(w1a, w1b),
        b1, w2, b2, s, r, dp, drop, sms=sms)


@pytest.mark.parametrize("f", [3, 33, 256])
@pytest.mark.parametrize("k", [1, 7, 300])
def test_transposed_image_unpacks_to_w1t_with_zero_padding(f, k):
    rng = np.random.default_rng(f * 1000 + k)
    w1a = _t(rng.normal(size=(f, k)).astype(np.float32)).to(torch.bfloat16)
    w1b = _t(rng.normal(size=(f, k)).astype(np.float32)).to(torch.bfloat16)
    packed = hm.pack_head_weights_t(w1a, w1b)
    ft = -(-f // hm.F_PART) * hm.F_PART
    kp = hm.padded_dims(f, k)[1]
    assert packed.dtype == torch.bfloat16 and packed.shape == (2 * ft * kp,)
    full = hm.unpack_head_weights_t(packed, f, k)
    assert full.shape == (2, kp, ft)
    assert torch.equal(full[0, :k, :f], w1a.t())
    assert torch.equal(full[1, :k, :f], w1b.t())
    pad = torch.ones(full.shape, dtype=torch.bool)
    pad[:, :k, :f] = False
    assert not bool(full[pad].any())
    # element (feature n, hidden kk) of W1b's slice of part 0, hidden chunk
    # 0 sits in core matrix (n // 8, kk // 8) of the second half: the
    # descriptors' stride byte offset 1024, leading byte offset 128
    for n, kk in ((0, 0), (min(f, hm.F_PART) - 1, min(k, hm.CHUNK) - 1)):
        at = (hm.F_PART * hm.CHUNK + (n // 8) * 512 + (kk // 8) * 64
              + (n % 8) * 8 + kk % 8)
        assert packed[at] == w1b[n, kk]
    for part in range(ft // hm.F_PART):
        for hc in range(kp // hm.CHUNK):
            for half in (0, 1):
                assert torch.equal(
                    hm.chunk_weights_t(packed, f, k, part, hc, half),
                    full[half, hc * hm.CHUNK:(hc + 1) * hm.CHUNK,
                         part * hm.F_PART:(part + 1) * hm.F_PART])


@pytest.mark.parametrize("q,k", [(1, 1), (130, 7), (300, 300)])
def test_dz1_image_layout(q, k):
    """Element (e, c) of dz1 sits at ``dz1_offset``: per 64-edge block and
    K tile, 8-edge groups of 32 core matrices (8 edges x 8 hidden), so an
    8 x 8 core matrix is 128 contiguous bytes, the next 8 hidden columns
    128 bytes on and the next 8 edges 4096 bytes on."""
    kp = hm.padded_dims(1, k)[1]
    rows = -(-q // hm.EDGE_TILE) * hm.EDGE_TILE
    assert hm.dz1_numel(q, k) == rows * kp
    dz1 = torch.arange(rows * kp, dtype=torch.float64).reshape(rows, kp)
    image = hm._to_dz1_image(dz1)
    e, c = torch.meshgrid(torch.arange(rows), torch.arange(kp),
                          indexing="ij")
    assert torch.equal(image[hm.dz1_offset(e, c, k)], dz1)
    assert torch.equal(hm._from_dz1_image(image, kp), dz1)
    at = hm.dz1_offset(torch.tensor([0, 8, 0, 64]), torch.tensor([8, 0, 256,
                                                                  0]), k)
    assert at.tolist()[:2] == [64, 8 * hm.N_TILE]     # 128 and 4096 bytes
    if kp > hm.N_TILE:
        assert at[2] == hm.DZ1_ROWS * hm.N_TILE        # the next K tile
    assert at[3] == hm.DZ1_ROWS * kp                   # the next 64 edges


@pytest.mark.parametrize("q,f,k,sms", [(200_000, 256, 256, 132),
                                       (199_963, 256, 256, 132),
                                       (77, 40, 50, 132), (1, 3, 1, 132),
                                       (5000, 260, 300, 7)])
def test_weight_splits_cover_the_edges(q, f, k, sms):
    per, splits = hm.weight_splits(q, f, k, sms)
    fp, kp = hm.padded_dims(f, k)
    assert per % hm.SPLIT_CHUNK == 0 and splits >= 1
    assert (splits - 1) * per < q <= splits * per
    blocks = (fp // hm.CHUNK) * (kp // hm.N_TILE) * splits
    assert blocks <= max(sms, (fp // hm.CHUNK) * (kp // hm.N_TILE))
    if (q, f, k) == (200_000, 256, 256):
        assert splits == 33 and blocks == 132


def test_backward_shared_memory_fits_one_block_per_sm():
    for k in (1, 256, ss.MAX_HIDDEN):
        sizes = hm.bwd_smem_bytes(k)
        assert max(sizes.values()) <= 232_448, sizes
    assert hm.bwd_smem_bytes(256)["dz1"] == (hm.SMEM_BYTES
                                             + (2 * 256 + 4) * 4 + 256 * 8)


def _close(got, want, dtype, q):
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        scale = float(b.abs().max())
        err = (a - b).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-5 * scale + q * 2 ** -24, (
                name, float(err.max()))
        else:
            tol = 2 ** -6 * b.abs() + 1e-3 * scale
            assert bool((err <= tol).all()), (name, float(err.max()))
            assert float(err.max()) <= 1e-3 * scale + 1e-12, name


@pytest.mark.parametrize("f,k", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop_rate", [0.0, 0.3])
@pytest.mark.parametrize("side", ["senders", "receivers"])
def test_schedule_matches_plain_backward(f, k, dtype, drop_rate, side):
    h, head, s, r, dp = _case(f, k)
    # the wrapper's swap: the sorted side comes first, W1b negated
    if side == "senders":
        s = np.sort(s)
    else:
        r = np.sort(r)
        s, r = r, s
        head = (np.concatenate([head[0][:f], -head[0][f:]]),) + head[1:]
    th = _t(h).to(dtype)
    split = ss.split_head(th, *[_t(a) for a in head])
    drop = HeadDropout.make(drop_rate, 23, "cpu")
    want = ss.score_head_bwd_plain(th, *split, _t(s), _t(r), _t(dp), drop)
    # sms=7: several splits of the weight pass even at q=300
    got = _schedule(th, split, _t(s), _t(r), _t(dp), drop, sms=7)
    _close(got, want, dtype, s.shape[0])
    if drop_rate:      # the mask is on: it changes the gradients
        nodrop = _schedule(th, split, _t(s), _t(r), _t(dp), None, sms=7)
        assert not torch.allclose(got[3], nodrop[3])


@pytest.mark.parametrize("f,k", SHAPES)
def test_schedule_matches_jax_pallas_vjp(f, k):
    h, head, s, r, dp = _case(f, k, q=77)
    s, r = np.clip(s, 0, h.shape[0] - 1), np.clip(r, 0, h.shape[0] - 1)

    def fwd(h_, w1, b1, w2, b2):
        return jax_score_head_sampled(h_, w1, b1, w2, b2, jnp.asarray(s),
                                      jnp.asarray(r), block=64,
                                      interpret=True)

    _, vjp = jax.vjp(fwd, *[jnp.asarray(a) for a in (h, *head)])
    dh_j, dfc1_j, db1_j, dfc2_j, db2_j = vjp(jnp.asarray(dp))
    th = _t(h)
    split = ss.split_head(th, *[_t(a) for a in head])
    dh, dw1a, dw1b, db1, dw2, db2 = _schedule(th, split, _t(s), _t(r),
                                              _t(dp), None)
    for name, got, want in (
            ("dh", dh, dh_j), ("dfc1", torch.cat([dw1a, dw1b]), dfc1_j),
            ("db1", db1, db1_j), ("dfc2", dw2[:, None], dfc2_j),
            ("db2", db2, db2_j)):
        want = np.asarray(want, np.float64).reshape(tuple(got.shape))
        np.testing.assert_allclose(
            got.double().numpy(), want, rtol=1e-4,
            atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_operands_dispatch_on_dtype(dtype):
    f, k, q = 33, 7, 10
    h = torch.randn(6, f).to(dtype)
    w1a, w1b = torch.randn(f, k).to(dtype), torch.randn(f, k).to(dtype)
    hk, bf16, pitch, wpack, wpack_t, dz1 = ss.bwd_operands(h, w1a, w1b, q)
    if dtype == torch.bfloat16:       # the tensor cores' operands
        assert bf16 == 1 and pitch == 40 and hk.shape == (6, 40)
        assert torch.equal(wpack, hm.pack_head_weights(w1a, w1b))
        assert torch.equal(wpack_t, hm.pack_head_weights_t(w1a, w1b))
        assert dz1.shape == (hm.dz1_numel(q, k),) and dz1.dtype == dtype
    else:                             # the CUDA cores read h and W1 as is
        assert bf16 == 0 and pitch == f and hk is h
        assert wpack is None and wpack_t is None
        assert dz1.shape == (q, k) and dz1.dtype == dtype

"""The port's tile-pair index and score-head ops (plain versions, on the
CPU) against the JAX package, and the score head's dropout mask.

Inputs are made with numpy from a seed and fed to both sides; f32. Values:
rtol 1e-5 (atol 1e-6 on probabilities); gradients: rtol 1e-4 with atol
1e-5 * max|grad|. The mask cannot match the TPU's in-kernel bits, so the
JAX comparison runs without dropout and the mask is tested on its own: its
keep fraction, its identity between forward and backward and across
``sorted_side``, its independence of the chunk size, and a literal table of
``hash32`` values that ``tests/test_torch_cuda.py`` holds the card to.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgs_gnn_tpu.core.graph import Graph as JGraph
from sgs_gnn_tpu.ops.score_sampled import score_head_sampled_reference
from sgs_gnn_tpu.ops.score_tiles import (
    build_tile_index as jax_build_tile_index, score_head_tiles_fallback,
    score_head_tiles_reference)

from sgs_gnn_tpu_torch.core import Graph
from sgs_gnn_tpu_torch.ops import dropout as dr
from sgs_gnn_tpu_torch.ops import score_sampled as ss
from sgs_gnn_tpu_torch.ops.score_tiles import (build_tile_index,
                                               score_head_tiles,
                                               score_head_tiles_plain)

# (seed, counter, hash32): csrc/common.cuh's definition evaluated in
# integer arithmetic; tests/test_torch_cuda.py holds the card to it
HASH32_TABLE = [(0, 0, 1107962638), (0, 1, 1320027387), (1, 0, 1613265885),
                (12345, 255, 2028518022), (2147483646, 272891903, 2596186920),
                (7, 4294967301, 2906286678), (99, 1099511640121, 4220018807)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _head(rng, f, k):
    return tuple(a.astype(np.float32) for a in (
        rng.normal(size=(2 * f, k)) / np.sqrt(2 * f),
        rng.normal(size=(k,)) * 0.1, rng.normal(size=(k, 1)) / np.sqrt(k),
        rng.normal(size=(1,)) * 0.1))


def _grad_close(got, want, name):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("pad,sort", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_tile_index_and_graph_fields_match_jax(pad, sort):
    rng = np.random.default_rng(1)
    n, e, c = 70, 1500, 3
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = rng.integers(0, c, n)
    train = rng.random(n) < 0.5
    prob = rng.uniform(0.1, 1.0, e).astype(np.float32)
    kw = dict(prob=prob, num_classes=c, sort_by_receiver=sort,
              pad_edges_to=e + 37 if pad else None, pad_edge_node=n - 1,
              tile_index=True, tile_t=16, tile_b=32)
    jg = JGraph.build(x, ei, y, train, ~train, None, **kw)
    tg = Graph.build(x, ei, y, train, ~train, None, device="cpu", **kw)
    assert tg.tile_t == jg.tile_t == 16 and tg.tile_b == jg.tile_b == 32
    for name in ("tile_ls", "tile_lr", "tile_su", "tile_rv", "tile_perm",
                 "tile_prob", "tile_mask", "tile_aux", "edge_aux",
                 "senders", "receivers"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    if pad:       # padding edges are never valid slots, in tile space too
        assert int(tg.tile_mask.sum()) == e
    ti = build_tile_index(ei[0], ei[1], n, t=16, b=32)
    tj = jax_build_tile_index(ei[0], ei[1], n, t=16, b=32)
    for a, b in zip(ti, tj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # too much padding: no index, as in the JAX package
    assert build_tile_index(ei[0, :40], ei[1, :40], n, t=16, b=32) is None
    assert jax_build_tile_index(ei[0, :40], ei[1, :40], n, t=16, b=32) is None


def test_score_head_tiles_matches_jax_reference():
    rng = np.random.default_rng(2)
    n, e, f, k, t, b = 45, 900, 32, 32, 16, 32      # N not a multiple of t
    ei = rng.integers(0, n, (2, e))
    ti = build_tile_index(ei[0], ei[1], n, t=t, b=b, max_overhead=10.0)
    h = rng.normal(size=(n, f)).astype(np.float32)
    head = _head(rng, f, k)
    tile = (ti.ls, ti.lr, ti.su, ti.rv)
    ref = score_head_tiles_reference(*[jnp.asarray(a) for a in (h, *head,
                                                                *tile)],
                                     t=t, bk=b)
    fallback = score_head_tiles_fallback(*[jnp.asarray(a) for a in
                                           (h, *head, *tile)], t=t, bk=b)
    out = score_head_tiles(*[_t(a) for a in (h, *head, *tile)], t=t, bk=b)
    assert out.dtype == torch.float32 and out.shape == (ti.ls.shape[0],)
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(fallback), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("sorted_side", ["", "senders", "receivers"])
def test_score_head_sampled_grads_match_jax(sorted_side):
    rng = np.random.default_rng(3)
    n, f, k, q = 40, 32, 32, 200
    h = rng.normal(size=(n, f)).astype(np.float32)
    head = _head(rng, f, k)
    s = rng.integers(0, n, q).astype(np.int32)
    r = rng.integers(0, n, q).astype(np.int32)
    if sorted_side == "senders":
        s = np.sort(s)
    elif sorted_side == "receivers":
        r = np.sort(r)
    dp = rng.normal(size=q).astype(np.float32)

    def jloss(h_, w1, b1, w2, b2):
        p = score_head_sampled_reference(h_, w1, b1, w2, b2, jnp.asarray(s),
                                         jnp.asarray(r))
        return jnp.sum(p * jnp.asarray(dp)), p

    (_, p_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(
        *[jnp.asarray(a) for a in (h, *head)])
    params = [_t(a).requires_grad_() for a in (h, *head)]
    p_t = ss.score_head_sampled(*params, _t(s), _t(r),
                                sorted_side=sorted_side)
    g_t = torch.autograd.grad(p_t, params, _t(dp))
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j),
                               rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("h", "fc1_kernel", "fc1_bias", "fc2_kernel",
                           "fc2_bias"), g_t, g_j):
        _grad_close(a.numpy(), b, name)


def test_dropout_keep_fraction_within_4_sigma():
    rate = 0.3
    drop = dr.HeadDropout.make(rate, 12345, "cpu")
    keep = dr.keep_mask(drop, 1000, 400, 256)              # 102,400 units
    frac = float(keep.float().mean())
    sigma = np.sqrt(rate * (1 - rate) / keep.numel())
    assert abs(frac - (1 - rate)) <= 4 * sigma, frac
    # rows and columns are not stuck: every slot and unit keeps some
    assert bool(keep.any(0).all()) and bool(keep.any(1).all())
    other = dr.keep_mask(dr.HeadDropout.make(rate, 12346, "cpu"), 1000, 400,
                         256)
    agree = float((keep == other).float().mean())
    expect = (1 - rate) ** 2 + rate ** 2                   # independent
    assert abs(agree - expect) <= 4 * np.sqrt(expect * (1 - expect)
                                              / keep.numel())
    assert dr.HeadDropout.make(0.0, 1, "cpu").thresh == 0


def test_dropout_mask_shared_by_forward_backward_and_sides():
    rng = np.random.default_rng(4)
    n, f, k, q, rate, seed = 30, 16, 24, 150, 0.5, 77
    h = _t(rng.normal(size=(n, f)).astype(np.float32))
    head = [_t(a) for a in _head(rng, f, k)]
    s = _t(rng.integers(0, n, q).astype(np.int32))
    r = _t(rng.integers(0, n, q).astype(np.int32))
    dp = _t(rng.normal(size=q).astype(np.float32))
    keep = dr.keep_mask(dr.HeadDropout.make(rate, seed, "cpu"), 0, q, k)

    def explicit(h_, w1, b1, w2, b2):
        hu, hv = h_[s.long()], h_[r.long()]
        z = torch.relu((hu * hv) @ w1[:f] + (hu - hv) @ w1[f:] + b1)
        z = torch.where(keep, z / (1 - rate), 0.0)
        return torch.sigmoid(z @ w2[:, 0] + b2)

    params = [t.clone().requires_grad_() for t in (h, *head)]
    want = explicit(*params)
    g_want = torch.autograd.grad(want, params, dp)
    outs = []
    for side in ("", "senders", "receivers"):
        params = [t.clone().requires_grad_() for t in (h, *head)]
        out = ss.score_head_sampled(*params, s, r, drop_rate=rate, seed=seed,
                                    sorted_side=side)
        got = torch.autograd.grad(out, params, dp)
        np.testing.assert_allclose(out.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(got, g_want):
            _grad_close(a.numpy(), b.numpy(), side)
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])           # same kernel math
    torch.testing.assert_close(outs[0], outs[2], rtol=0, atol=1e-6)


def test_dropout_mask_independent_of_chunk_size():
    rng = np.random.default_rng(5)
    n, f, k, q = 50, 8, 40, 333
    h = _t(rng.normal(size=(n, f)).astype(np.float32))
    split = ss.split_head(h, *[_t(a) for a in _head(rng, f, k)])
    s = _t(rng.integers(0, n, q).astype(np.int32))
    r = _t(rng.integers(0, n, q).astype(np.int32))
    drop = dr.HeadDropout.make(0.3, 9, "cpu")
    # the mask is bit-equal (below); the matmuls may block their sums by
    # the chunk's rows, hence 1e-6 and not equality on the probabilities
    whole = ss.score_head_plain(h, *split, s, r, drop, chunk=q)
    for chunk in (1, 7, 64, 100):
        torch.testing.assert_close(ss.score_head_plain(
            h, *split, s, r, drop, chunk=chunk), whole, rtol=0, atol=1e-6)
    parts = torch.cat([dr.keep_mask(drop, e0, 37, k)
                       for e0 in range(0, 37 * 9, 37)])
    assert torch.equal(parts, dr.keep_mask(drop, 0, 37 * 9, k))
    ti = build_tile_index(rng.integers(0, n, 900), rng.integers(0, n, 900),
                          n, t=16, b=32, max_overhead=10.0)
    tile = [_t(a) for a in (ti.ls, ti.lr, ti.su, ti.rv)]
    tiles = [score_head_tiles_plain(h, *split, *tile, 16, 32, drop, chunk=c)
             for c in (32, 50, 4096)]
    for other in tiles[1:]:
        torch.testing.assert_close(other, tiles[0], rtol=0, atol=1e-6)


def test_hash32_twin_matches_table_and_integer_definition():
    for seed, counter, want in HASH32_TABLE:
        assert int(dr.hash32(seed, torch.tensor([counter]))[0]) == want
    m32 = 0xFFFFFFFF

    def fmix(v):
        v ^= v >> 16
        v = (v * 0x85EBCA6B) & m32
        v ^= v >> 13
        v = (v * 0xC2B2AE35) & m32
        return v ^ (v >> 16)

    def ref(seed, c):
        inner = fmix(seed ^ 0x243F6A88 ^ (((c >> 32) * 0x9E3779B9) & m32))
        return fmix((c & m32) ^ inner)

    rng = np.random.default_rng(6)
    cs = rng.integers(0, 2 ** 50, 500)
    seeds = rng.integers(0, 2 ** 31 - 1, 500)
    got = dr.hash32_plain(torch.from_numpy(seeds), torch.from_numpy(cs))
    assert [int(v) for v in got] == [ref(int(a), int(c))
                                     for a, c in zip(seeds, cs)]

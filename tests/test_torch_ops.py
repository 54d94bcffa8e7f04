"""The port's ops (plain PyTorch versions, on the CPU) against the JAX
package: Pallas kernels in interpret mode, their plain references, and the
XLA paths. Inputs are made with numpy from a seed and fed to both sides;
f32, rtol = atol = 1e-5 unless a case says otherwise."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgs_gnn_tpu.ops.edge_gather import gather_rows as jax_gather_rows
from sgs_gnn_tpu.ops.scatter_pallas import (
    _segment_sum_scalar_pallas, required_band as jax_required_band,
    scatter_add_pallas)
from sgs_gnn_tpu.ops.score_sampled import (
    score_head_sampled as jax_score_head_sampled,
    score_head_sampled_reference)
from sgs_gnn_tpu.ops.spmm import spmm as jax_spmm

from sgs_gnn_tpu_torch.ops import (gather_rows, required_band, scatter_add,
                                   score_head_sampled, segment_sum_scalar,
                                   spmm)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_scatter_add_matches_pallas_and_segment_sum(rng, dtype, order):
    n, e, f = 37, 300, 32
    vals = rng.normal(size=(e, f)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    if order == "sorted":
        ids = np.sort(ids)
    jv = jnp.asarray(vals, dtype=dtype)
    tv = _t(vals).to(getattr(torch, dtype))
    out = scatter_add(tv, _t(ids), n)
    assert out.dtype == torch.float32 and out.shape == (n, f)
    # bf16 inputs are rounded identically on both sides; the f32 sums
    # differ only in order
    pallas = scatter_add_pallas(jv, jnp.asarray(ids), n, block=128,
                                interpret=True)
    seg = jax.ops.segment_sum(jv.astype(jnp.float32), jnp.asarray(ids), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(seg), **TOL)


def test_scatter_add_drops_out_of_range_ids(rng):
    n, e, f = 9, 64, 5
    vals = rng.normal(size=(e, f)).astype(np.float32)
    ids = rng.integers(-2, n + 2, e).astype(np.int32)
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), n)
    np.testing.assert_allclose(scatter_add(_t(vals), _t(ids), n).numpy(),
                               np.asarray(ref), **TOL)
    w = vals[:, 0].copy()
    ref_w = jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(ids), n)
    np.testing.assert_allclose(segment_sum_scalar(_t(w), _t(ids), n).numpy(),
                               np.asarray(ref_w), **TOL)


def test_segment_sum_scalar_matches_pallas(rng):
    # the TPU kernel rounds w to bf16: quarter-integers are exact in bf16
    n, e = 45, 700
    w = (rng.integers(0, 16, e) / 4.0).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    pallas = _segment_sum_scalar_pallas(jnp.asarray(w), jnp.asarray(ids), n,
                                        block=256, interpret=True)
    out = segment_sum_scalar(_t(w), _t(ids), n)
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    ones = np.ones(e, np.float32)
    pallas1 = _segment_sum_scalar_pallas(jnp.asarray(ones), jnp.asarray(ids),
                                         n, block=256, interpret=True)
    np.testing.assert_array_equal(
        segment_sum_scalar(_t(ones), _t(ids), n).numpy(), np.asarray(pallas1))


def test_segment_sum_scalar_weighted_matches_segment_sum(rng):
    n, e = 30, 500
    w = rng.uniform(0.0, 1.0, e).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    ref = jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(ids), n)
    np.testing.assert_allclose(segment_sum_scalar(_t(w), _t(ids), n).numpy(),
                               np.asarray(ref), **TOL)


def _head(rng, f, k):
    w1 = (rng.normal(size=(2 * f, k)) * 0.2).astype(np.float32)
    b1 = (rng.normal(size=(k,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(k, 1)) * 0.2).astype(np.float32)
    b2 = (rng.normal(size=(1,)) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def test_score_head_sampled_matches_pallas_and_reference(rng):
    n, f, k, q = 40, 128, 128, 77          # the TPU kernel wants F, K % 128
    h = rng.normal(size=(n, f)).astype(np.float32)
    head = _head(rng, f, k)
    s = rng.integers(0, n, q).astype(np.int32)
    r = rng.integers(0, n, q).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (h, *head, s, r)]
    pallas = jax_score_head_sampled(*jargs, block=64, interpret=True)
    ref = score_head_sampled_reference(*jargs)
    out = score_head_sampled(*[_t(a) for a in (h, *head, s, r)])
    assert out.dtype == torch.float32 and out.shape == (q,)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_score_head_sampled_narrow_matches_reference(rng):
    n, f, k, q = 13, 32, 24, 50
    h = rng.normal(size=(n, f)).astype(np.float32)
    head = _head(rng, f, k)
    s = rng.integers(0, n, q).astype(np.int32)
    r = rng.integers(0, n, q).astype(np.int32)
    ref = score_head_sampled_reference(*[jnp.asarray(a)
                                         for a in (h, *head, s, r)])
    out = score_head_sampled(*[_t(a) for a in (h, *head, s, r)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_score_head_sampled_rejects_dropout_and_bad_shapes(rng):
    f, k = 8, 8
    h = _t(rng.normal(size=(5, f)).astype(np.float32))
    w1, b1, w2, b2 = [_t(a) for a in _head(rng, f, k)]
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        score_head_sampled(h, w1, b1, w2, b2, ids, ids, drop_rate=0.1)
    with pytest.raises(ValueError):
        score_head_sampled(h, w1[:f], b1, w2, b2, ids, ids)


@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_matches_jax(rng, weighted):
    n, e, f = 25, 200, 16
    x = rng.normal(size=(n, f)).astype(np.float32)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0, 1, e).astype(np.float32) if weighted else None
    ref = jax_spmm(jnp.asarray(s), jnp.asarray(r),
                   None if w is None else jnp.asarray(w), jnp.asarray(x), n)
    out = spmm(_t(s), _t(r), None if w is None else _t(w), _t(x), n)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_spmm_bf16_keeps_dtype(rng):
    n, e, f = 11, 90, 8
    x = rng.normal(size=(n, f)).astype(np.float32)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    ref = jax_spmm(jnp.asarray(s), jnp.asarray(r), None,
                   jnp.asarray(x, jnp.bfloat16), n)
    out = spmm(_t(s), _t(r), None, _t(x).to(torch.bfloat16), n)
    assert out.dtype == torch.bfloat16
    # both sum bf16 messages in f32 and round once to bf16: equal up to
    # one bf16 ulp where the f32 sums straddle a rounding boundary
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-5)


def test_gather_rows_matches_jax(rng):
    table = rng.normal(size=(19, 7)).astype(np.float32)
    idx = rng.integers(0, 19, 55).astype(np.int32)
    ref = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(gather_rows(_t(table), _t(idx)).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("n,e,block", [(2048, 20000, 1024), (50, 3000, 256),
                                       (7, 5, 1024)])
def test_required_band_matches_jax(rng, n, e, block):
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    assert required_band(ids, block) == jax_required_band(ids, block)
    assert required_band(ids[:0]) == jax_required_band(ids[:0])

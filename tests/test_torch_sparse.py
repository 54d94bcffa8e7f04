"""The port's sorted scatter (K7's plain version), fused SpMM (K8's plain
version) and the ops and layer over them, against the JAX package on the
CPU: the Pallas kernels in interpret mode, ``gather_rows``, ``spmm`` and
``GCNConv``. The same numpy inputs go to both. Tolerances: values rtol =
atol = 1e-5 (f32 sums in another order); gradients rtol 1e-4 with atol
1e-5 * max|grad| per tensor."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgs_gnn_tpu.models.layers import GCNConv as JGCNConv
from sgs_gnn_tpu.ops.edge_gather import gather_rows as jax_gather_rows
from sgs_gnn_tpu.ops.scatter_pallas import (required_band,
                                            scatter_add_sorted_pallas)
from sgs_gnn_tpu.ops.spmm_pallas import _spmm_pallas_core, _spmm_pallas_impl

from sgs_gnn_tpu_torch.models import GCNConv, params_from_jax
from sgs_gnn_tpu_torch.ops import gather_rows, scatter_add_sorted, spmm
from sgs_gnn_tpu_torch.ops.scatter import sorted_band_keep
from sgs_gnn_tpu_torch.ops.spmm import spmm_fused_plain

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(700, 40, 32), (512, 8, 8), (3, 5, 16), (1, 1, 8)]  # (e, n, f)
BLOCK = 256


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grad_close(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


# ------------------------------------------------------- K7: sorted scatter


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("band_kind", ["required", "undersized"])
@pytest.mark.parametrize("e,n,f", SHAPES)
def test_scatter_add_sorted_plain_matches_pallas(e, n, f, band_kind, dtype):
    """Ragged E (not a multiple of the block), padding ids past N at the
    end, and a band below ``required_band`` where both drop the same
    items."""
    rng = np.random.default_rng(e + n + f)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    band = required_band(ids, block=BLOCK) if band_kind == "required" else 8
    ids = np.concatenate([ids, [n, n + band, n + band]]).astype(np.int32)
    vals = rng.normal(size=(ids.shape[0], f)).astype(np.float32)
    jvals = jnp.asarray(vals).astype(dtype)
    want = scatter_add_sorted_pallas(jvals, jnp.asarray(ids), n, band=band,
                                     block=BLOCK, interpret=True)
    tvals = _t(vals).to(getattr(torch, dtype))
    got = scatter_add_sorted(tvals, _t(ids), n, band, block=BLOCK)
    assert got.dtype == torch.float32 and got.shape == (n, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    keep = sorted_band_keep(_t(ids), n, band, BLOCK).numpy()
    assert not keep[e:].any()                         # padding ids dropped
    if band_kind == "required":
        assert keep[:e].all()                         # the exact segment sum
    elif (e, n) == (700, 40):
        assert not keep[:e].all()                     # the band cut some


def test_scatter_add_sorted_rejects_bad_band():
    vals, ids = torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32)
    for band, block in ((0, 1024), (8, 0)):
        with pytest.raises(ValueError):
            scatter_add_sorted(vals, ids, 2, band, block)


@pytest.mark.parametrize("e,n", [(200, 30), (3000, 50)])
def test_gather_rows_sorted_band_vjp_matches_jax(e, n):
    rng = np.random.default_rng(e)
    f = 16
    table = rng.normal(size=(n, f)).astype(np.float32)
    idx = np.sort(rng.integers(0, n, e)).astype(np.int32)
    band = required_band(idx)
    cot = rng.normal(size=(e, f)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda t_: jax_gather_rows(t_, jnp.asarray(idx),
                                                   sorted_band=band),
                         jnp.asarray(table))
    tt = _t(table).requires_grad_()
    out_t = gather_rows(tt, _t(idx), sorted_band=band)
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    g_t, = torch.autograd.grad(out_t, tt, _t(cot))
    _grad_close(g_t.numpy(), vjp(jnp.asarray(cot))[0], "d table")
    g_k1, = torch.autograd.grad(gather_rows(tt, _t(idx)), tt, _t(cot))
    np.testing.assert_allclose(g_t.numpy(), g_k1.numpy(), **TOL)


# ------------------------------------------------------- K8: fused SpMM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_fused_plain_matches_pallas(weighted, dtype):
    rng = np.random.default_rng(7)
    for e, n, f in SHAPES:
        s = rng.integers(0, n, e).astype(np.int32)
        r = rng.integers(0, n, e).astype(np.int32)
        w = (rng.random(e) if weighted else np.ones(e)).astype(np.float32)
        x = rng.normal(size=(n, f)).astype(np.float32)
        want = _spmm_pallas_impl(jnp.asarray(s), jnp.asarray(r),
                                 jnp.asarray(w), jnp.asarray(x).astype(dtype),
                                 n, block=BLOCK, interpret=True)
        got = spmm_fused_plain(_t(s), _t(r), _t(w),
                               _t(x).to(getattr(torch, dtype)), n)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"e={e} n={n} f={f}")


@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_fused_grads_match_pallas_core(weighted):
    """dx (K8 on the reversed edges) and dw (the SDDMM) against the JAX
    fused SpMM's custom VJP in interpret mode."""
    rng = np.random.default_rng(8)
    e, n, f = 300, 20, 16
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    js, jr = jnp.asarray(s), jnp.asarray(r)
    jw = jnp.asarray(w) if weighted else jnp.ones(e, jnp.float32)

    def loss_j(w_, x_):
        return jnp.sum(jnp.sin(_spmm_pallas_core(n, True, js, jr, w_, x_)))

    val_j, (gw_j, gx_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jw, jnp.asarray(x))
    tw = _t(w).requires_grad_() if weighted else None
    tx = _t(x).requires_grad_()
    out = spmm(_t(s), _t(r), tw, tx, n, backend="fused")
    assert out.dtype == torch.float32
    loss_t = torch.sum(torch.sin(out))
    np.testing.assert_allclose(float(loss_t.detach()), float(val_j),
                               rtol=1e-5)
    if weighted:
        gw_t, gx_t = torch.autograd.grad(loss_t, (tw, tx))
        _grad_close(gw_t.numpy(), gw_j, "dw")
    else:
        gx_t, = torch.autograd.grad(loss_t, tx)
    _grad_close(gx_t.numpy(), gx_j, "dx")


def test_spmm_rejects_unknown_backend():
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="backend"):
        spmm(s, s, None, torch.zeros(2, 4), 2, backend="pallas")


@pytest.mark.parametrize("weighted", [False, True])
def test_gcnconv_fused_matches_flax_pallas(weighted):
    """The port's ``GCNConv(backend="fused")`` against the flax layer with
    ``backend="pallas"`` (off the TPU its SpMM takes the XLA route, the
    same function): output and the gradients of the parameters, x and the
    edge weights."""
    rng = np.random.default_rng(9)
    n, e, fin, fout = 30, 240, 12, 9
    x = rng.normal(size=(n, fin)).astype(np.float32)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0, 1, e).astype(np.float32) if weighted else None
    cot = rng.normal(size=(n, fout)).astype(np.float32)
    jm = JGCNConv(fout, backend="pallas")
    js, jr = jnp.asarray(s), jnp.asarray(r)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), js, jr,
                     None if w is None else jnp.asarray(w))

    def fwd_j(p, x_, w_):
        return jnp.sum(jm.apply(p, x_, js, jr, w_) * cot)

    jw = jnp.asarray(w) if weighted else None
    val_j, (gp_j, gx_j, gw_j) = jax.value_and_grad(fwd_j, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jw)
    tm = GCNConv(fin, fout, backend="fused")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_() if weighted else None
    out = tm(tx, _t(s), _t(r), tw)
    loss_t = torch.sum(out * _t(cot))
    np.testing.assert_allclose(float(loss_t.detach()), float(val_j), **TOL)
    inputs = [tx] + ([tw] if weighted else []) + list(tm.parameters())
    grads = dict(zip(["x"] + (["w"] if weighted else [])
                     + [k for k, _ in tm.named_parameters()],
                     torch.autograd.grad(loss_t, inputs)))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    for name, g in grads.items():
        ref = {"x": gx_j, "w": gw_j}.get(name)
        _grad_close(g.numpy(), want[name].numpy() if ref is None else ref,
                    name)

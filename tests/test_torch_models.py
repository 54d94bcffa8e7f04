"""The port's models and graph build (on the CPU, f32) against the JAX
package's flax modules and ``Graph.build``, with the flax weights moved over
by ``params_from_jax``. rtol = atol = 1e-5."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgs_gnn_tpu.core.graph import Graph as JGraph
from sgs_gnn_tpu.data.priors import degree_prior as jax_degree_prior
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.models.layers import GCNConv as JGCNConv

from sgs_gnn_tpu_torch.core import Graph
from sgs_gnn_tpu_torch.data import degree_prior
from sgs_gnn_tpu_torch.models import GCNConv, get_model, params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _edges(rng, n, e):
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


@pytest.mark.parametrize("weighted", [False, True])
def test_gcnconv_matches_flax(rng, weighted):
    n, e, fin, fout = 30, 240, 12, 9
    x = rng.normal(size=(n, fin)).astype(np.float32)
    s, r = _edges(rng, n, e)
    w = rng.uniform(0, 1, e).astype(np.float32) if weighted else None
    jm = JGCNConv(fout)
    jargs = [jnp.asarray(a) for a in (x, s, r)]
    jw = None if w is None else jnp.asarray(w)
    params = jm.init(jax.random.PRNGKey(0), *jargs, jw)
    ref = jm.apply(params, *jargs, jw)
    tm = GCNConv(fin, fout)
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        out = tm(_t(x), _t(s), _t(r), None if w is None else _t(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(1)
    n, e, fin, hid, c = 40, 320, 10, 16, 5
    x = rng.normal(size=(n, fin)).astype(np.float32)
    s, r = _edges(rng, n, e)
    jm = jax_get_model("GCN", fin, hid, c, 0.3, "GCN")
    params = init_params(jm, jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(s), jnp.asarray(r))
    tm = get_model("GCN", fin, hid, c, 0.3, "GCN", device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))   # strict names
    return dict(jm=jm, params=params, tm=tm, x=x, s=s, r=r, rng=rng)


def test_params_from_jax_layout(models):
    sd = params_from_jax(_np_tree(models["params"]))
    assert sd["edge_prob_mlp.head.fc1.weight"].shape == (16, 32)
    assert sd["gcn1.lin.weight"].shape == (16, 10)
    np.testing.assert_array_equal(
        sd["gcn2.lin.weight"].numpy(),
        np.asarray(models["params"]["params"]["gcn2"]["lin"]["kernel"]).T)


def test_edge_prob_gcn_encode_and_score_from_match_flax(models):
    jm, params, tm = models["jm"], models["params"], models["tm"]
    x, s, r = models["x"], models["s"], models["r"]
    jx, js, jr = (jnp.asarray(a) for a in (x, s, r))
    h_ref = jm.apply(params, jx, js, jr, True, method="encode_scorer")
    # score a different edge set than the propagation one
    ss, sr = _edges(models["rng"], x.shape[0], 77)
    p_ref = jm.apply(params, h_ref, jnp.asarray(ss), jnp.asarray(sr), True,
                     method="score_from_embeddings")
    with torch.no_grad():
        h = tm.edge_prob_mlp.encode(_t(x), _t(s), _t(r))
        p = tm.edge_prob_mlp.score_from(h, _t(ss), _t(sr))
        p_all = tm.score_edges(_t(x), _t(s), _t(r), _t(ss), _t(sr))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), **TOL)
    np.testing.assert_array_equal(p_all.numpy(), p.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_gnn_model_matches_flax(models, weighted):
    jm, params, tm = models["jm"], models["params"], models["tm"]
    x, s, r = models["x"], models["s"], models["r"]
    w = (np.random.default_rng(3).uniform(0, 1, s.shape[0]).astype(np.float32)
         if weighted else None)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                   None if w is None else jnp.asarray(w), deterministic=True)
    with torch.no_grad():
        out = tm(_t(x), _t(s), _t(r), None if w is None else _t(w))
    assert out.shape == (x.shape[0], 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_get_model_rejects_other_backbones():
    with pytest.raises(NotImplementedError, match="GIN"):
        get_model("GIN", 4, 8, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="MLP"):
        get_model("GCN", 4, 8, 2, edge_mlp_type="MLP", device="cpu")


def test_get_model_same_seed_same_weights():
    a = get_model("GCN", 6, 8, 3, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    b = get_model("GCN", 6, 8, 3, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


@pytest.mark.parametrize("pad", [None, 700])
def test_graph_build_matches_jax(rng, pad):
    n, e, f = 50, 600, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    s, r = _edges(rng, n, e)
    y = rng.integers(0, 4, n).astype(np.int32)
    train = rng.random(n) < 0.5
    prior = degree_prior(s, r, n)
    np.testing.assert_allclose(prior, jax_degree_prior(s, r, n), rtol=1e-6)
    kw = dict(prob=prior, num_classes=4, sort_by_receiver=True,
              pad_edges_to=pad, pad_edge_node=n - 1)
    jg = JGraph.build(x, np.stack([s, r]), y, train, ~train, None, **kw)
    tg = Graph.build(x, np.stack([s, r]), y, train, ~train, None,
                     device="cpu", **kw)
    for name in ("x", "senders", "receivers", "y", "train_mask", "val_mask",
                 "test_mask", "prob", "edge_mask", "edge_aux"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.receiver_band == jg.receiver_band > 0
    assert tg.num_classes == jg.num_classes
    assert tg.senders.dtype == torch.int32 and tg.tile_ls is None

"""The port's dense-subgraph route (``ops/dense_graph.py``, the layers'
``DenseEdges`` branches, the learned step's decision) against its own
sparse route and against the JAX package's dense route, on the CPU in f32.

The same numpy inputs go to both packages and the flax weights are moved
by ``params_from_jax``. Layers: values rtol = atol = 1e-5, gradients
rtol 1e-4 with atol 1e-5 * max|grad| (``tests/test_torch_train.py``'s
rule). Steps: JAX's dense-parity tolerances (tests/test_train.py
``test_dense_subgraph_parity``): loss rtol 1e-5, gradients rtol 2e-4 /
atol 1e-6. Against JAX, sampling is frozen in both packages with
``tests/test_torch_train.py``'s helper and dropout is off; 'on' against
'off' in the port draws its own samples from one seed.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.core import Config as JConfig, Graph as JGraph
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.models import layers as jl
from sgs_gnn_tpu.train.pipelines import (
    make_learned_loss as jax_make_learned_loss)

from sgs_gnn_tpu_torch import Config, Graph, get_model, params_from_jax
from sgs_gnn_tpu_torch.models import (ChebConv, GATConv, GCNConv, GINConv,
                                      SAGEConv)
from sgs_gnn_tpu_torch.ops.dense_graph import (DenseEdges, dense_adj,
                                               dense_supported,
                                               use_dense_subgraph)
from sgs_gnn_tpu_torch.train.pipelines import make_learned_loss

from test_torch_train import _freeze, _grad_close, _np_tree
from test_train import _homophilous_graph

jdg = importlib.import_module("sgs_gnn_tpu.ops.dense_graph")

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
N, E, F_IN = 40, 300, 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, so parallel test workers do not wait at
    thread barriers; the port's float32 default dtype
    (tests/test_reference_oracle.py sets float64 when it is imported)."""
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(rng, n, e, isolated=7):
    """(senders, receivers) int32 with duplicates; ``isolated`` receives
    no edge."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    r[r == isolated] = (isolated + 1) % n
    return s, r


# ----------------------------------------------------------- dense_adj


def test_dense_adj_matches_numpy_and_jax(rng):
    n, e = 9, 120
    s, r = _edges(rng, n, e)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    valid = rng.random(e) < 0.7
    want = np.zeros((n, n), np.float64)
    np.add.at(want, (r, s), 1.0)
    assert want.max() > 1                      # duplicates accumulate
    got = dense_adj(_t(s), _t(r), n)
    assert isinstance(got, DenseEdges) and got.num_nodes == n
    assert got.adj.dtype == torch.float32
    np.testing.assert_array_equal(got.adj.numpy(), want)
    masked = np.zeros((n, n), np.float64)
    np.add.at(masked, (r[valid], s[valid]), 1.0)
    np.testing.assert_array_equal(
        dense_adj(_t(s), _t(r), n, valid=_t(valid)).adj.numpy(), masked)
    weighted = np.zeros((n, n), np.float64)
    np.add.at(weighted, (r[valid], s[valid]), w[valid])
    tw = _t(w).requires_grad_()
    a = dense_adj(_t(s), _t(r), n, weights=tw, valid=_t(valid)).adj
    np.testing.assert_allclose(a.detach().numpy(), weighted, **TOL)
    ja = jdg.dense_adj(jnp.asarray(s), jnp.asarray(r), n,
                       weights=jnp.asarray(w), valid=jnp.asarray(valid)).adj
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), **TOL)
    # the weights' gradient: the cotangent gathered at the flat ids
    cot = rng.normal(size=(n, n)).astype(np.float32)
    (gw,) = torch.autograd.grad(a, tw, _t(cot))
    np.testing.assert_allclose(gw.numpy(), np.where(valid, cot[r, s], 0.0),
                               **TOL)


def test_use_dense_subgraph_decisions():
    on = Config(dense_subgraph="on")
    for device in ("cpu", "cuda"):
        assert use_dense_subgraph(on, 2048, 200_000, device)
        assert not use_dense_subgraph(on.replace(dense_subgraph="off"),
                                      2048, 200_000, device)
        # auto engages on a TPU only in JAX; on neither device here
        assert not use_dense_subgraph(Config(), 2048, 200_000, device)
    # the threshold, N^2 in the flat ids' range, an empty graph
    assert use_dense_subgraph(on, 4096, 10, "cpu")
    assert not use_dense_subgraph(on, 4097, 10, "cpu")
    big = on.replace(dense_threshold=1 << 20)
    assert use_dense_subgraph(big, 46_340, 10, "cpu")
    assert not use_dense_subgraph(big, 46_341, 10, "cpu")
    assert not use_dense_subgraph(on, 0, 10, "cpu")
    # every backbone and scorer has a dense route; anything else has none
    for gnn in ("GCN", "GIN", "GAT", "Cheb"):
        for scorer in ("MLP", "GSAGE", "GCN"):
            assert dense_supported(gnn, scorer)
            assert dense_supported(gnn, scorer) == \
                jdg.dense_supported(gnn, scorer)
    assert not dense_supported("SAGE", "GCN")
    assert not use_dense_subgraph(on.replace(edge_mlp_type="GAT"), 64, 10,
                                  "cpu")
    # 'on' and 'off' decide as JAX's (whose 'auto' declines on the CPU)
    for mode in ("on", "off", "auto"):
        for n in (64, 5000):
            kw = dict(dense_subgraph=mode)
            assert use_dense_subgraph(Config(**kw), n, 4 * n, "cpu") == \
                jdg.use_dense_subgraph(JConfig(**kw), n, 4 * n)


# ----------------------------------------------------------------- layers


LAYERS = {
    "GCN": (lambda: jl.GCNConv(7), lambda: GCNConv(F_IN, 7)),
    "SAGE": (lambda: jl.SAGEConv(7), lambda: SAGEConv(F_IN, 7)),
    "GAT_h1": (lambda: jl.GATConv(7, heads=1, concat=False),
               lambda: GATConv(F_IN, 7, heads=1, concat=False)),
    "GAT_h2": (lambda: jl.GATConv(7, heads=2, concat=True),
               lambda: GATConv(F_IN, 7, heads=2, concat=True)),
    "GIN": (lambda: jl.GINConv(9, 7), lambda: GINConv(F_IN, 9, 7)),
    "Cheb_K2": (lambda: jl.ChebConv(7, K=2), lambda: ChebConv(F_IN, 7, K=2)),
}
# GCN and Cheb use edge weights (in the adjacency on the dense route); the
# other layers ignore them on both routes
LAYER_CASES = [(name, False) for name in LAYERS] + [("GCN", True),
                                                    ("Cheb_K2", True)]


@pytest.mark.parametrize("layer,weighted", LAYER_CASES)
def test_dense_layer_matches_sparse_and_flax(rng, layer, weighted):
    make_j, make_t = LAYERS[layer]
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    s, r = _edges(rng, N, E)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32) if weighted else None
    jm = make_j()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(s), jnp.asarray(r))
    jadj = jdg.dense_adj(jnp.asarray(s), jnp.asarray(r), N,
                         weights=None if w is None else jnp.asarray(w))

    def jfn(p, x_):
        return jm.apply(p, x_, jadj, None)

    @jax.jit
    def jvjp(p, x_, cot):
        out, vjp = jax.vjp(jfn, p, x_)
        return out, vjp(cot)

    shape = jax.eval_shape(jfn, params, jnp.asarray(x)).shape
    cot = rng.normal(size=shape).astype(np.float32)
    out_j, (g_params, g_x) = jvjp(params, jnp.asarray(x), jnp.asarray(cot))
    tm = make_t()
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    names, tparams = zip(*tm.named_parameters())
    tw = None if w is None else _t(w)
    adj = dense_adj(_t(s), _t(r), N, weights=tw)
    results = {}
    for route, args in (("dense", (adj, None, None)),
                        ("sparse", (_t(s), _t(r), tw))):
        tx = _t(x).requires_grad_()
        out = tm(tx, *args)
        assert bool(torch.isfinite(out).all()), route
        grads = torch.autograd.grad(out, list(tparams) + [tx], _t(cot))
        results[route] = (out.detach().numpy(), [g.numpy() for g in grads])
    (out_d, g_d), (out_s, g_s) = results["dense"], results["sparse"]
    np.testing.assert_allclose(out_d, np.asarray(out_j), **TOL)
    np.testing.assert_allclose(out_d, out_s, **TOL)
    want = params_from_jax(_np_tree(g_params))
    assert set(want) == set(names)
    for name, gd, gs in zip(names + ("x",), g_d, g_s):
        ref = np.asarray(g_x) if name == "x" else want[name].numpy()
        _grad_close(gd, ref, f"{name} vs JAX")
        _grad_close(gd, gs, f"{name} vs sparse")


def test_dense_gat_isolated_row_is_its_self_loop():
    # a node that receives no edge attends to itself alone: its output is
    # its own projection, and nothing is NaN
    adj = dense_adj(torch.tensor([0, 1, 2], dtype=torch.int32),
                    torch.tensor([1, 2, 1], dtype=torch.int32), 4)
    layer = GATConv(5, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(1))
    out = layer(x, adj, None)
    assert bool(torch.isfinite(out).all())
    with torch.no_grad():
        own = torch.nn.functional.linear(x, layer.lin.weight) + layer.bias
    np.testing.assert_allclose(out[[0, 3]].detach().numpy(),
                               own[[0, 3]].numpy(), **TOL)


# ----------------------------------------------------------------- steps


def _homophilous(rng):
    """tests/test_train.py's ``_homophilous_graph`` (60 nodes) as numpy
    arrays: x, edge_index, y, masks, classes."""
    g = _homophilous_graph(rng, n=60)
    masks = np.stack([np.asarray(m) for m in (g.train_mask, g.val_mask,
                                              g.test_mask)])
    return (np.asarray(g.x), np.asarray(g.edge_index), np.asarray(g.y),
            masks, g.num_classes)


def _graphs(x, ei, y, masks, c, **kw):
    e = ei.shape[1]
    kw = dict(prob=np.full(e, 1.0 / e, dtype=np.float32), num_classes=c,
              **kw)
    return (JGraph.build(x, ei, y, *masks, **kw),
            Graph.build(x, ei, y, *masks, device="cpu", **kw))


def _port_step(cfg, tm, tg, q, seed=0):
    loss, _ = make_learned_loss(cfg, tm, q)(
        tg, torch.Generator().manual_seed(seed))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, params, grads)}


def _check_step_pair(a, b, what):
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-5, err_msg=what)
    for name in grads_b:
        np.testing.assert_allclose(grads_a[name].numpy(),
                                   grads_b[name].numpy(),
                                   err_msg=f"{what}: {name}",
                                   **STEP_GRAD_TOL)


@pytest.fixture(scope="module")
def jax_models():
    """flax models and their initial parameters by (backbone, graph
    shapes): one init each, which JAX compiles."""
    cache = {}

    def get(cfg, jg):
        key = (cfg.GNN, jg.x.shape, jg.senders.shape)
        if key not in cache:
            jm = jax_get_model(cfg.GNN, jg.x.shape[1], cfg.nhid,
                               jg.num_classes, 0.0, cfg.edge_mlp_type)
            cache[key] = jm, init_params(jm, jax.random.PRNGKey(0), jg.x,
                                         jg.senders, jg.receivers)
        return cache[key]
    return get


def _step_parity(monkeypatch, jax_models, jg, tg, q, idx, rand_idx, **kw):
    """Port 'on' against port 'off' (own sampling, one seed), then, with
    sampling frozen in both packages, port 'on' against JAX 'on'."""
    jcfg = JConfig(mode="learned", reg1=True, reg2=True, drop_rate=0.0,
                   dense_subgraph="on", donate=False, nhid=16, **kw)
    tcfg = Config(mode="learned", reg1=True, reg2=True, drop_rate=0.0,
                  dense_subgraph="on", nhid=16, **kw)
    assert use_dense_subgraph(tcfg, tg.num_nodes, q, "cpu")
    jm, params = jax_models(jcfg, jg)
    tm = get_model(tcfg.GNN, tg.x.shape[1], tcfg.nhid, tg.num_classes, 0.0,
                   tcfg.edge_mlp_type, device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    steps = {d: _port_step(tcfg.replace(dense_subgraph=d), tm, tg, q)
             for d in ("on", "off")}
    assert np.isfinite(steps["on"][0])
    _check_step_pair(steps["on"], steps["off"], "port on vs off")
    _freeze(monkeypatch, idx, rand_idx)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        jax_make_learned_loss(jcfg, jm, q), has_aux=True))(
        params, jg, jax.random.PRNGKey(7))
    want = {k: v for k, v in params_from_jax(_np_tree(grads_j)).items()}
    _check_step_pair(_port_step(tcfg, tm, tg, q), (float(loss_j), want),
                     "port on vs JAX on")


@pytest.mark.parametrize("gnn", ["GCN", "GIN", "Cheb", "GAT"])
@pytest.mark.parametrize("pipeline,conditional,sparse_mlp", [
    ("hybrid", True, False),
    ("hybrid", False, True),
    ("two_pass", True, False),
    ("two_pass", False, True),
])
def test_dense_subgraph_parity(monkeypatch, jax_models, gnn, pipeline,
                               conditional, sparse_mlp):
    rng = np.random.default_rng(0)
    jg, tg = _graphs(*_homophilous(rng))
    e = tg.num_edges
    q = int(e * 0.3)
    idx = np.sort(rng.choice(e, q, replace=False)).astype(np.int32)
    rand_idx = rng.choice(e, q, replace=False).astype(np.int32)
    _step_parity(monkeypatch, jax_models, jg, tg, q, idx, rand_idx,
                 pipeline=pipeline, GNN=gnn, conditional=conditional,
                 sparse_edge_mlp=sparse_mlp)


@pytest.mark.parametrize("pipeline", ["hybrid", "two_pass"])
def test_dense_subgraph_parity_padded_edges(monkeypatch, jax_models,
                                            pipeline):
    """Padding selections (valid edges < q) are zeroed alike on the dense
    route: the graph is padded and q exceeds its valid edges by 50."""
    rng = np.random.default_rng(0)
    x, ei, y, masks, c = _homophilous(rng)
    e = ei.shape[1]
    # a ghost node (zero features, no mask) takes the padding self-loops
    x = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    y = np.concatenate([y, [0]]).astype(np.int32)
    masks = np.concatenate([masks, np.zeros((3, 1), bool)], axis=1)
    jg, tg = _graphs(x, ei, y, masks, c, pad_edges_to=e + 200,
                     pad_edge_node=60)
    q = e + 50
    pad = np.flatnonzero(~tg.edge_mask.numpy())
    valid = np.flatnonzero(tg.edge_mask.numpy())
    idx = np.sort(np.concatenate([valid, pad[:50]])).astype(np.int32)
    rand_idx = rng.permutation(np.concatenate([valid, pad[-50:]])) \
        .astype(np.int32)
    _step_parity(monkeypatch, jax_models, jg, tg, q, idx, rand_idx,
                 pipeline=pipeline, conditional=True)

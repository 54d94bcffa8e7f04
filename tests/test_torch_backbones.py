"""The port's other layers, scorers and backbones (GIN, GAT, Cheb; the MLP
and GraphSAGE scorers) and the segment ops their aggregations use, against
the JAX package on the CPU in f32.

The same numpy inputs go to both packages and the flax weights are moved
over by ``params_from_jax``. Tolerances: values rtol = atol = 1e-5;
gradients rtol 1e-4 with atol 1e-5 * max|grad| per tensor (the rule of
``tests/test_torch_train.py``, whose sampler-freezing helpers the step
test reuses: fixed indices with the weight formulas of ``sample_edges``,
dropout off, JAX's step under ``jax.disable_jit()``).
"""
import csv
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.core import Config as JConfig, Graph as JGraph
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.models import layers as jl
from sgs_gnn_tpu.train.optim import (edge_filter as jax_edge_filter,
                                     gnn_filter_for as jax_gnn_filter_for,
                                     make_mask)
from sgs_gnn_tpu.train.pipelines import (
    make_learned_loss as jax_make_learned_loss)

from sgs_gnn_tpu_torch import Config, DualOptimizer, Graph, get_model
from sgs_gnn_tpu_torch.models import (ChebConv, EdgeProbMLP, EdgeProbSAGE,
                                      GATConv, GINConv, SAGEConv,
                                      params_from_jax)
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.train.pipelines import make_learned_loss

from test_torch_train import _freeze, _grad_close, _np_tree

# the modules (each package's ops/__init__ re-exports the functions)
jgn = importlib.import_module("sgs_gnn_tpu.ops.gcn_norm")
jseg = importlib.import_module("sgs_gnn_tpu.ops.segment")
tgn = importlib.import_module("sgs_gnn_tpu_torch.ops.gcn_norm")
tseg = importlib.import_module("sgs_gnn_tpu_torch.ops.segment")

TOL = dict(rtol=1e-5, atol=1e-5)
N, E, F_IN, HID, C, HEADS = 40, 300, 12, 16, 5, 2
GNNS = ("GCN", "GIN", "GAT", "Cheb")
SCORERS = ("MLP", "GSAGE", "GCN")
PAIRS = [(g, s) for g in GNNS for s in SCORERS]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run faster on one intra-op thread when parallel test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(rng, n, e, isolated=None):
    """(senders, receivers) int32; ``isolated`` receives no edge."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    if isolated is not None:
        r[r == isolated] = (isolated + 1) % n
    return s, r


# ------------------------------------------------------------ segment ops


def _vjp_both(jfn, tfn, args, cot_rng):
    """Values and VJPs (one random cotangent) of a JAX and a torch function
    of the same numpy arguments."""
    out_j, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    out_t = tfn(*targs)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    finite = np.isfinite(np.asarray(out_j))
    cot = np.where(finite, cot_rng.normal(size=out_j.shape), 0.0) \
        .astype(np.float32)
    g_j = vjp(jnp.asarray(cot))
    g_t = torch.autograd.grad(out_t, targs, _t(cot))
    return g_t, g_j


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_softmax"])
@pytest.mark.parametrize("width", [None, 3])
def test_segment_ops_match_jax_in_value_and_gradient(rng, op, width):
    n, e, empty = 17, 120, 5
    _, ids = _edges(rng, n, e, isolated=empty)
    shape = (e,) if width is None else (e, width)
    data = rng.normal(size=shape).astype(np.float32)
    jfn = getattr(jseg, op)
    tfn = getattr(tseg, op)
    if op == "segment_softmax" and width is not None:
        # the JAX GAT layer vmaps the 1-D softmax over its heads
        def jcall(d):
            return jax.vmap(lambda c: jfn(c, jnp.asarray(ids), n), in_axes=1,
                            out_axes=1)(d)
    else:
        def jcall(d):
            return jfn(d, jnp.asarray(ids), n)
    (g_t,), (g_j,) = _vjp_both(jcall, lambda d: tfn(d, _t(ids), n), [data],
                               rng)
    _grad_close(g_t.numpy(), g_j, op)
    if op != "segment_softmax":
        out = tfn(_t(data), _t(ids), n)
        assert out.shape == (n,) + shape[1:]
        want = float("-inf") if op == "segment_max" else 0.0
        assert bool((out[empty] == want).all())          # the empty segment


def test_segment_softmax_non_finite_max_counts_as_zero():
    # a segment whose logits are all -inf: its max is mapped to 0, so its
    # weights are 0 / 1e-16 = 0, as in JAX
    ids = np.array([0, 0, 1, 1, 2], np.int32)
    logits = np.array([0.5, -1.0, -np.inf, -np.inf, 2.0], np.float32)
    want = np.asarray(jseg.segment_softmax(jnp.asarray(logits),
                                           jnp.asarray(ids), 4))
    got = tseg.segment_softmax(_t(logits), _t(ids), 4).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got[2] == got[3] == 0.0 and got[4] == 1.0


@pytest.mark.parametrize("add_loops", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_gcn_norm_matches_jax(rng, add_loops, weighted):
    n, e = 19, 150
    s, r = _edges(rng, n, e, isolated=3)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)

    def jfn(w_):
        return jgn.gcn_norm(jnp.asarray(s), jnp.asarray(r),
                            w_ if weighted else None, n, add_loops)[2]

    def tfn(w_):
        return tgn.gcn_norm(_t(s), _t(r), w_ if weighted else None, n,
                            add_loops)[2]

    if weighted:
        (g_t,), (g_j,) = _vjp_both(jfn, tfn, [w], rng)
        _grad_close(g_t.numpy(), g_j, "d weights")
    else:
        np.testing.assert_allclose(tfn(None).numpy(), np.asarray(jfn(None)),
                                   **TOL)
    ts, tr, _ = tgn.gcn_norm(_t(s), _t(r), None, n, add_loops)
    js, jr, _ = jgn.gcn_norm(jnp.asarray(s), jnp.asarray(r), None, n,
                             add_loops)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert ts.dtype == torch.int32
    norm_t, loop_t = tgn.gcn_norm_terms(_t(s), _t(r), _t(w), n)
    norm_j, loop_j = jgn.gcn_norm_terms(jnp.asarray(s), jnp.asarray(r),
                                        jnp.asarray(w), n)
    np.testing.assert_allclose(norm_t.numpy(), np.asarray(norm_j), **TOL)
    np.testing.assert_allclose(loop_t.numpy(), np.asarray(loop_j), **TOL)


# ----------------------------------------------------------------- layers


LAYERS = {
    "SAGE": (lambda: jl.SAGEConv(7), lambda: SAGEConv(F_IN, 7)),
    "GIN": (lambda: jl.GINConv(9, 7), lambda: GINConv(F_IN, 9, 7)),
    "GAT_h1_mean": (lambda: jl.GATConv(7, heads=1, concat=False),
                    lambda: GATConv(F_IN, 7, heads=1, concat=False)),
    "GAT_h2_concat": (lambda: jl.GATConv(7, heads=2, concat=True),
                      lambda: GATConv(F_IN, 7, heads=2, concat=True)),
    "Cheb_K1": (lambda: jl.ChebConv(7, K=1), lambda: ChebConv(F_IN, 7, K=1)),
    "Cheb_K3": (lambda: jl.ChebConv(7, K=3), lambda: ChebConv(F_IN, 7, K=3)),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_matches_flax_in_value_and_gradient(rng, layer, weighted):
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    s, r = _edges(rng, N, E, isolated=7)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32) if weighted else None
    make_j, make_t = LAYERS[layer]
    jm = make_j()
    jw = None if w is None else jnp.asarray(w)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(s), jnp.asarray(r), jw)

    def jfn(p, x_):
        return jm.apply(p, x_, jnp.asarray(s), jnp.asarray(r), jw)

    @jax.jit
    def jvjp(p, x_, cot):
        out, vjp = jax.vjp(jfn, p, x_)
        return out, vjp(cot)

    shape = jax.eval_shape(jfn, params, jnp.asarray(x)).shape
    cot = rng.normal(size=shape).astype(np.float32)
    out_j, (g_params, g_x) = jvjp(params, jnp.asarray(x), jnp.asarray(cot))
    tm = make_t()
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    tx = _t(x).requires_grad_()
    out_t = tm(tx, _t(s), _t(r), None if w is None else _t(w))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    names, tparams = zip(*tm.named_parameters())
    grads = torch.autograd.grad(out_t, list(tparams) + [tx], _t(cot))
    want = params_from_jax(_np_tree(g_params))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        _grad_close(g.numpy(), want[name].numpy(), name)
    _grad_close(grads[-1].numpy(), np.asarray(g_x), "x")


def test_gat_attention_rows_normalized():
    # twin of tests/test_models.py: with identical node features attention
    # averages the neighbours, so a node with in-degree 3 equals a node
    # with its self-loop alone
    x = torch.ones(8, 6)
    s = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    r = torch.tensor([4, 4, 4, 5], dtype=torch.int32)
    layer = GATConv(6, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = layer(x, s, r).numpy()
    np.testing.assert_allclose(out[4], out[5], rtol=1e-5)


def test_cheb_k1_is_linear(rng):
    # twin of tests/test_models.py: K=1 ignores the graph
    x = _t(rng.normal(size=(N, F_IN)).astype(np.float32))
    s, r = (_t(a) for a in _edges(rng, N, E))
    layer = ChebConv(F_IN, 4, K=1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out1 = layer(x, s, r)
        out2 = layer(x, torch.zeros_like(s), r)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


# ------------------------------------------------------- models and groups


@pytest.fixture(scope="module")
def pairs():
    """JAX models and flax parameters of every backbone x scorer pair,
    GAT with ``HEADS`` heads, on one graph."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    s, r = _edges(rng, N, E, isolated=11)
    out = {}
    for gnn, scorer in PAIRS:
        jm = jax_get_model(gnn, F_IN, HID, C, 0.3, scorer, heads=HEADS)
        params = init_params(jm, jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(s), jnp.asarray(r))
        out[gnn, scorer] = (jm, params)
    return dict(models=out, x=x, s=s, r=r, rng=rng)


def _port(gnn, scorer, params):
    tm = get_model(gnn, F_IN, HID, C, 0.3, scorer, heads=HEADS, device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    return tm


@pytest.mark.parametrize("gnn,scorer", PAIRS)
def test_params_from_jax_loads_strictly(pairs, gnn, scorer):
    jm, params = pairs["models"][gnn, scorer]
    sd = params_from_jax(_np_tree(params))
    tm = get_model(gnn, F_IN, HID, C, 0.3, scorer, heads=HEADS, device="cpu")
    missing, unexpected = tm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    for name, p in tm.state_dict().items():
        torch.testing.assert_close(p, sd[name], rtol=0, atol=0)
    if gnn == "GAT":
        # attention vectors keep their (1, H, F) shape, untransposed
        assert sd["GAT_conv1.att_src"].shape == (1, HEADS, HID)
        np.testing.assert_array_equal(
            sd["GAT_conv1.att_dst"].numpy(),
            np.asarray(params["params"]["GAT_conv1"]["att_dst"]))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("gnn,scorer", PAIRS)
def test_backbone_forward_matches_flax(pairs, gnn, scorer, weighted):
    jm, params = pairs["models"][gnn, scorer]
    x, s, r = pairs["x"], pairs["s"], pairs["r"]
    w = (np.random.default_rng(3).uniform(0, 1, E).astype(np.float32)
         if weighted else None)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                   None if w is None else jnp.asarray(w), deterministic=True)
    tm = _port(gnn, scorer, params)
    with torch.no_grad():
        out = tm(_t(x), _t(s), _t(r), None if w is None else _t(w))
    assert out.shape == (N, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("scorer", ["MLP", "GSAGE"])
def test_scorer_encode_and_score_from_match_flax(pairs, scorer):
    jm, params = pairs["models"]["GCN", scorer]
    x, s, r = pairs["x"], pairs["s"], pairs["r"]
    jx, js, jr = (jnp.asarray(a) for a in (x, s, r))
    h_ref = jm.apply(params, jx, js, jr, True, method="encode_scorer")
    ss, sr = _edges(pairs["rng"], N, 77)       # other edges than the prop
    p_ref = jm.apply(params, h_ref, jnp.asarray(ss), jnp.asarray(sr), True,
                     method="score_from_embeddings")
    tm = _port("GCN", scorer, params)
    assert isinstance(tm.edge_prob_mlp,
                      EdgeProbMLP if scorer == "MLP" else EdgeProbSAGE)
    with torch.no_grad():
        h = tm.encode_scorer(_t(x), _t(s), _t(r))
        p = tm.score_from_embeddings(h, _t(ss), _t(sr))
        p_all = tm.score_edges(_t(x), _t(s), _t(r), _t(ss), _t(sr))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), **TOL)
    np.testing.assert_array_equal(p_all.numpy(), p.numpy())


@pytest.mark.parametrize("gnn,scorer", PAIRS)
def test_dual_optimizer_groups_match_jax_masks(pairs, gnn, scorer):
    _, params = pairs["models"][gnn, scorer]
    tm = _port(gnn, scorer, params)
    opt = DualOptimizer.create(tm, gnn, 0.01, 5e-4)
    for grp, pred in (("gnn", jax_gnn_filter_for(gnn)),
                      ("edge", jax_edge_filter)):
        want = params_from_jax(make_mask(params, pred))
        got = dict(zip(opt.names, opt.masks[grp]))
        assert got == {k: bool(v) for k, v in want.items()}, grp
    both = {n for n, g, e in zip(opt.names, opt.masks["gnn"],
                                 opt.masks["edge"]) if g and e}
    # the scorer's 'gcn1' is in the gnn group only under the 'gcn' token
    want_both = {n for n in opt.names if n.startswith("edge_prob_mlp.gcn")} \
        if gnn in ("GCN", "Cheb") else set()
    assert both == want_both


def test_default_scorer_matches_jax():
    jm = jax_get_model("GCN", F_IN, HID, C)
    tm = get_model("GCN", F_IN, HID, C, device="cpu")
    assert jm.edge_mlp_type == "MLP"
    assert type(tm.edge_prob_mlp).__name__ == "EdgeProbMLP"


# --------------------------------------------------- frozen one-step parity


Q_STEP = 120


def _step_graph(seed=4):
    rng = np.random.default_rng(seed)
    n, e = 48, 480
    s, r = _edges(rng, n, e)
    x = rng.normal(size=(n, F_IN)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    perm = rng.permutation(n)
    tr = np.zeros(n, bool); tr[perm[:n // 2]] = True
    va = np.zeros(n, bool); va[perm[n // 2:3 * n // 4]] = True
    te = np.zeros(n, bool); te[perm[3 * n // 4:]] = True
    prob = rng.uniform(0.2, 1.0, e).astype(np.float32)
    prob /= prob.sum()
    kw = dict(prob=prob, num_classes=C, sort_by_receiver=True,
              tile_index=True, tile_t=16, tile_b=32)
    jg = JGraph.build(x, np.stack([s, r]), y, tr, va, te, **kw)
    tg = Graph.build(x, np.stack([s, r]), y, tr, va, te, device="cpu", **kw)
    assert tg.tile_t == jg.tile_t > 0
    space = np.flatnonzero(np.asarray(jg.tile_mask))
    idx = np.sort(rng.choice(space, Q_STEP, replace=False)).astype(np.int32)
    rand_idx = np.sort(rng.choice(e, Q_STEP, replace=False)).astype(np.int32)
    return jg, tg, idx, rand_idx


@pytest.mark.parametrize("gnn,scorer", [("GIN", "MLP"), ("GAT", "GSAGE"),
                                        ("Cheb", "GCN"), ("GCN", "MLP"),
                                        ("GCN", "GSAGE")])
def test_hybrid_rescore_step_matches_jax(monkeypatch, gnn, scorer):
    jg, tg, idx, rand_idx = _step_graph()
    _freeze(monkeypatch, idx, rand_idx)
    kw = dict(pipeline="hybrid", mode="learned", conditional=True,
              sparse_edge_mlp=True, reg1=True, reg2=True, nhid=HID,
              drop_rate=0.0, lr=0.01, GNN=gnn, edge_mlp_type=scorer,
              gat_heads=HEADS)
    jcfg, tcfg = JConfig(donate=False, **kw), Config(**kw)
    jm = jax_get_model(gnn, F_IN, HID, C, 0.0, scorer, heads=HEADS)
    params = init_params(jm, jax.random.PRNGKey(3), jg.x, jg.senders,
                         jg.receivers)
    tm = get_model(gnn, F_IN, HID, C, 0.0, scorer, heads=HEADS, device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    with jax.disable_jit():
        (loss_j, (gate_j, lf1_j, rf1_j)), grads_j = jax.value_and_grad(
            jax_make_learned_loss(jcfg, jm, Q_STEP), has_aux=True)(
            params, jg, jax.random.PRNGKey(0))
    loss_t, (gate_t, lf1_t, rf1_t) = make_learned_loss(tcfg, tm, Q_STEP)(
        tg, torch.Generator().manual_seed(0))
    names, tparams = zip(*tm.named_parameters())
    grads_t = torch.autograd.grad(loss_t, tparams, allow_unused=True)
    assert bool(gate_t) == bool(gate_j)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    np.testing.assert_allclose([float(lf1_t), float(rf1_t)],
                               [float(lf1_j), float(rf1_j)], rtol=1e-6)
    want = params_from_jax(_np_tree(grads_j))
    assert set(want) == set(names)
    for name, g in zip(names, grads_t):
        g = np.zeros(want[name].shape) if g is None else g.numpy()
        _grad_close(g, want[name].numpy(), name)


# ------------------------------------------------------------- experiment


def test_gat_gsage_learned_experiment_runs(tmp_path):
    cfg = Config(dataset="SyntheticSBM", metis_threshold=20000,
                 shape_classes=2, nhid=HID, runs=1, num_samples_eval=3,
                 mode="learned", pipeline="hybrid", GNN="GAT",
                 edge_mlp_type="GSAGE", conditional=True, reg1=True,
                 reg2=True, sparse_edge_mlp=True, epochs=2, convergence=0.0,
                 scan_epoch="off", save_csv=True,
                 results_dir=str(tmp_path))
    lines = []
    (res,) = driver.run_experiment(cfg, log_fn=lines.append, device="cpu")
    assert res.epoch_route == "loop"
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    f1s = [res.final_train_f1, res.final_val_f1, res.final_test_f1]
    assert all(0.0 <= f <= 1.0 for f in f1s)
    assert res.plan["parts"] == 4
    with open(tmp_path / "SyntheticSBM" / "0.2.csv") as fh:
        rows = list(csv.reader(fh))
    assert rows[1][3] == "learned"

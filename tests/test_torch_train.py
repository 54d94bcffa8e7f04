"""The port's training slice (``train/``, ``eval/`` and the autograd of the
ops) against the JAX package, on the CPU in f32.

The same numpy inputs and the same flax weights (moved by
``params_from_jax``) go to both packages. Sampling is frozen in both the
way ``tests/test_reference_oracle.py`` freezes it, by replacing each
package's samplers with fixed-index versions that keep the weight
formulas, and dropout is off, so a step is deterministic on both sides.
Tolerances: values rtol 1e-5; gradients rtol 1e-4 with atol
1e-5 * max|grad| per tensor; parameters after Adam steps rtol 1e-5 (fixed
gradients) or, along a trajectory, the lr-wide band that
``test_reference_oracle.py`` explains (Adam turns f32 rounding noise on
near-zero gradients into +-lr per step).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sgs_gnn_tpu.eval.evaluate as jax_evaluate
import sgs_gnn_tpu.train.pipelines as jax_pipelines
from sgs_gnn_tpu.core import Config as JConfig, Graph as JGraph
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.ops.edge_gather import gather_rows as jax_gather_rows
from sgs_gnn_tpu.ops.scatter_pallas import (
    segment_sum_scalar as jax_segment_sum_scalar)
from sgs_gnn_tpu.ops.spmm import spmm as jax_spmm
from sgs_gnn_tpu.sparsify.sampling import _normalized as jax_normalized
from sgs_gnn_tpu.train import losses as jl
from sgs_gnn_tpu.train.optim import DualOptimizer as JDualOptimizer
from sgs_gnn_tpu.train.pipelines import (
    make_learned_loss as jax_make_learned_loss,
    make_train_step as jax_make_train_step)

import sgs_gnn_tpu_torch.eval.evaluate as evaluate
import sgs_gnn_tpu_torch.train.pipelines as pipelines
from sgs_gnn_tpu_torch import (Config, DualOptimizer, Graph, aggregate_eval,
                               get_model, make_eval_step, make_train_step,
                               params_from_jax)
from sgs_gnn_tpu_torch.ops import (gather_rows, scatter_add,
                                   segment_sum_scalar, spmm)
from sgs_gnn_tpu_torch.sparsify.sampling import _normalized as torch_normalized
from sgs_gnn_tpu_torch.train import losses as tl
from sgs_gnn_tpu_torch.train.pipelines import make_learned_loss

N, E, F_IN, C, HID, Q = 64, 1600, 8, 4, 32, 200
SEED = 11        # graph seed of the trajectory test: a mixed gate sequence


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grad_close(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


# ------------------------------------------------------------ op autograd


@pytest.mark.parametrize("op", ["scatter_add", "gather_rows",
                                "segment_sum_scalar", "spmm",
                                "spmm_weighted"])
def test_op_gradients_match_jax(rng, op):
    n, e, f = 23, 180, 6
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    vals = rng.normal(size=(e, f)).astype(np.float32)
    w = rng.uniform(0, 1, e).astype(np.float32)
    if op == "scatter_add":
        args, jfn = (vals,), lambda v: jax.ops.segment_sum(v, r, n)
        tfn = lambda v: scatter_add(v, _t(r), n)
    elif op == "gather_rows":
        args, jfn = (x,), lambda t_: jax_gather_rows(t_, jnp.asarray(s))
        tfn = lambda t_: gather_rows(t_, _t(s))
    elif op == "segment_sum_scalar":
        args = (w,)
        jfn = lambda w_: jax_segment_sum_scalar(w_, jnp.asarray(r), n)
        tfn = lambda w_: segment_sum_scalar(w_, _t(r), n)
    elif op == "spmm":
        args = (x,)
        jfn = lambda x_: jax_spmm(jnp.asarray(s), jnp.asarray(r), None, x_, n)
        tfn = lambda x_: spmm(_t(s), _t(r), None, x_, n)
    else:
        args = (w, x)
        jfn = lambda w_, x_: jax_spmm(jnp.asarray(s), jnp.asarray(r), w_, x_,
                                      n)
        tfn = lambda w_, x_: spmm(_t(s), _t(r), w_, x_, n)
    out_j = jfn(*[jnp.asarray(a) for a in args])
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    g_j = jax.vjp(jfn, *[jnp.asarray(a) for a in args])[1](jnp.asarray(cot))
    targs = [_t(a).requires_grad_() for a in args]
    out_t = tfn(*targs)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    g_t = torch.autograd.grad(out_t, targs, _t(cot))
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        _grad_close(a.numpy(), b, f"{op} arg {i}")


# ----------------------------------------------------------------- losses


def test_losses_match_jax_in_value_and_gradient(rng):
    n, c, q = 40, 5, 120
    logits = rng.normal(size=(n, c)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    s = rng.integers(0, n, q).astype(np.int32)
    r = rng.integers(0, n, q).astype(np.int32)
    p = rng.uniform(0.01, 0.99, q).astype(np.float32)
    p[:4] = [0.0, 1.0, 0.0, 1.0]             # saturated sigmoids
    flags = (mask[s] & mask[r]).astype(np.int32) | \
        ((y[s] == y[r]).astype(np.int32) << 1)
    emb = rng.normal(size=(n, c)).astype(np.float32)
    emb[3] = 0.0                              # a zero embedding
    valid = rng.random(q) < 0.9
    cases = {
        "masked_cross_entropy": (
            (logits,), lambda l_: jl.masked_cross_entropy(l_, y, mask),
            lambda l_: tl.masked_cross_entropy(l_, _t(y), _t(mask))),
        "assortative_bce": (
            (p,), lambda p_: jl.assortative_bce(p_, s, r, y, mask),
            lambda p_: tl.assortative_bce(p_, _t(s), _t(r), _t(y),
                                          _t(mask))),
        "assortative_bce_flags": (
            (p,), lambda p_: jl.assortative_bce_flags(p_, flags),
            lambda p_: tl.assortative_bce_flags(p_, _t(flags))),
        "consistency_loss": (
            (p, emb),
            lambda p_, e_: jl.consistency_loss(p_, s, r, e_,
                                               valid=jnp.asarray(valid)),
            lambda p_, e_: tl.consistency_loss(p_, _t(s), _t(r), e_,
                                               valid=_t(valid))),
    }
    for name, (args, jfn, tfn) in cases.items():
        v_j, g_j = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
            *[jnp.asarray(a) for a in args])
        targs = [_t(a).requires_grad_() for a in args]
        v_t = tfn(*targs)
        g_t = torch.autograd.grad(v_t, targs)
        np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-5,
                                   err_msg=name)
        for a, b in zip(g_t, g_j):
            assert np.isfinite(a.numpy()).all(), name
            _grad_close(a.numpy(), b, name)
    # p exactly 0 and 1: each clamped log term is 100
    bce = tl._BceClamped.apply(torch.tensor([0.0, 1.0]),
                               torch.tensor([1.0, 0.0]))
    assert bce.tolist() == [100.0, 100.0]
    assert float(tl.micro_f1(_t(logits), _t(y), _t(mask))) == pytest.approx(
        float(jl.micro_f1(logits, y, mask)), rel=1e-6)


# -------------------------------------------------------------- optimizer


def test_dual_optimizer_matches_jax():
    rng = np.random.default_rng(5)
    jm = jax_get_model("GCN", F_IN, HID, C, 0.0, "GCN")
    x = jnp.asarray(rng.normal(size=(N, F_IN)).astype(np.float32))
    s = jnp.asarray(rng.integers(0, N, 300).astype(np.int32))
    params = init_params(jm, jax.random.PRNGKey(0), x, s, s)
    grads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                              * 1e-2), params) for _ in range(3)]
    for method, gates in (("step_learned", [True, False, True]),
                          ("step_gnn_only", [None] * 3),
                          ("step_all", [None] * 3)):
        jopt = JDualOptimizer.create(params, "GCN", 0.01, 5e-4)
        jstate, jp = jopt.init(params), params
        tm = get_model("GCN", F_IN, HID, C, 0.0, "GCN", device="cpu")
        tm.load_state_dict(params_from_jax(_np_tree(params)))
        topt = DualOptimizer.create(tm, "GCN", 0.01, 5e-4)
        for gr, gate in zip(grads, gates):
            tg = params_from_jax(_np_tree(gr))
            tgrads = [tg[name] for name in topt.names]
            if gate is None:
                jp, jstate = getattr(jopt, method)(jp, gr, jstate)
                getattr(topt, method)(tgrads)
            else:
                jp, jstate = jopt.step_learned(jp, gr, jstate,
                                               jnp.asarray(gate))
                topt.step_learned(tgrads, torch.tensor(gate))
            want = params_from_jax(_np_tree(jp))
            for name, p in tm.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[name].numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=name)
        # a group that never stepped has no state yet: count 0
        for grp in ("gnn", "edge", "all"):
            count = topt.state[grp].count if grp in topt.state else 0
            assert int(count) == int(getattr(jstate, grp).count)


# -------------------------------------------------- frozen one-step parity


def _graph(seed, tile):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    perm = rng.permutation(N)
    tr = np.zeros(N, bool); tr[perm[:N // 2]] = True
    va = np.zeros(N, bool); va[perm[N // 2:3 * N // 4]] = True
    te = np.zeros(N, bool); te[perm[3 * N // 4:]] = True
    prob = rng.uniform(0.2, 1.0, E).astype(np.float32)
    prob /= prob.sum()
    kw = dict(prob=prob, num_classes=C, sort_by_receiver=True,
              tile_index=tile, tile_t=16, tile_b=32)
    jg = JGraph.build(x, np.stack([s, r]), y, tr, va, te, **kw)
    tg = Graph.build(x, np.stack([s, r]), y, tr, va, te, device="cpu", **kw)
    assert bool(jg.tile_t) == tile and tg.tile_t == jg.tile_t
    space = np.flatnonzero(np.asarray(jg.tile_mask)) if tile \
        else np.arange(E)
    idx = np.sort(rng.choice(space, Q, replace=False)).astype(np.int32)
    rand_idx = np.sort(rng.choice(E, Q, replace=False)).astype(np.int32)
    return jg, tg, idx, rand_idx


def edge_sampler_of(sample_edges):
    """An ``edge_sampler`` whose draws are ``sample_edges``' calls."""
    def edge_sampler(edge_probs, prior, q, beta, istest=False,
                     edge_mask=None):
        return lambda generator: sample_edges(generator, edge_probs, prior,
                                              q, beta, istest, edge_mask)
    return edge_sampler


def _freeze(monkeypatch, idx, rand_idx):
    """Fixed-index samplers in both packages, with the weight formulas of
    ``sample_edges`` (the oracle test's ``_freeze_sampling``)."""
    j_idx, j_rand = jnp.asarray(idx), jnp.asarray(rand_idx)
    t_idx, t_rand = _t(idx), _t(rand_idx)

    def jax_sample_edges(key, edge_probs, prior, q, beta, istest=False,
                         edge_mask=None, approx=False, bf16=True):
        samples = jax_normalized(edge_probs, edge_mask)
        if not istest:
            prior_ = jnp.where(edge_mask, prior, 0.0) \
                if edge_mask is not None else prior
            samples = (1.0 - beta) * samples + beta * prior_
        sel = samples[j_idx]
        st = jax.lax.stop_gradient(1.0 - sel) + sel
        return j_idx, jnp.clip(edge_probs[j_idx] * st, 0.0, 1.0)

    def torch_sample_edges(generator, edge_probs, prior, q, beta,
                           istest=False, edge_mask=None):
        samples = torch_normalized(edge_probs, edge_mask)
        if not istest:
            prior_ = torch.where(edge_mask, prior, 0.0) \
                if edge_mask is not None else prior
            samples = (1.0 - beta) * samples + beta * prior_
        sel = samples[t_idx.long()]
        st = (1.0 - sel).detach() + sel
        return t_idx, torch.clamp(edge_probs[t_idx.long()] * st, 0.0, 1.0)

    for mod in (jax_pipelines, jax_evaluate):
        monkeypatch.setattr(mod, "sample_edges", jax_sample_edges)
    monkeypatch.setattr(jax_pipelines, "sample_prior_edges",
                        lambda *a, **k: j_rand)
    monkeypatch.setattr(pipelines, "sample_edges", torch_sample_edges)
    monkeypatch.setattr(evaluate, "edge_sampler",
                        edge_sampler_of(torch_sample_edges))
    monkeypatch.setattr(pipelines, "sample_prior_edges",
                        lambda *a, **k: t_rand)


def _cfg(conditional=True):
    kw = dict(pipeline="hybrid", mode="learned", conditional=conditional,
              sparse_edge_mlp=True, reg1=True, reg2=True, nhid=HID,
              drop_rate=0.0, lr=0.01, donate=False, num_samples_eval=3)
    return JConfig(**kw), Config(**kw)


def _models(jg, init_seed=3):
    jm = jax_get_model("GCN", F_IN, HID, C, 0.0, "GCN")
    params = init_params(jm, jax.random.PRNGKey(init_seed), jg.x, jg.senders,
                         jg.receivers)
    tm = get_model("GCN", F_IN, HID, C, 0.0, "GCN", device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    return jm, params, tm


@pytest.mark.parametrize("tile", [True, False])
@pytest.mark.parametrize("conditional", [True, False])
def test_one_step_loss_gate_and_gradients_match_jax(monkeypatch, tile,
                                                    conditional):
    jg, tg, idx, rand_idx = _graph(4, tile)
    _freeze(monkeypatch, idx, rand_idx)
    jcfg, tcfg = _cfg(conditional)
    jm, params, tm = _models(jg)
    (loss_j, (gate_j, lf1_j, rf1_j)), grads_j = jax.value_and_grad(
        jax_make_learned_loss(jcfg, jm, Q), has_aux=True)(
        params, jg, jax.random.PRNGKey(0))
    loss_t, (gate_t, lf1_t, rf1_t) = make_learned_loss(tcfg, tm, Q)(
        tg, torch.Generator().manual_seed(0))
    names, tparams = zip(*tm.named_parameters())
    grads_t = torch.autograd.grad(loss_t, tparams, allow_unused=True)
    assert bool(gate_t) == bool(gate_j)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose([float(lf1_t), float(rf1_t)],
                               [float(lf1_j), float(rf1_j)], rtol=1e-6)
    want = params_from_jax(_np_tree(grads_j))
    assert set(want) == set(names)
    scorer_moved = False
    for name, g in zip(names, grads_t):
        g = np.zeros(want[name].shape) if g is None else g.numpy()
        _grad_close(g, want[name].numpy(), name)
        scorer_moved |= name.startswith("edge_prob_mlp") and bool(
            np.abs(g).max() > 0)
    # the head's gradient reaches the scorer unless the gate failed
    assert scorer_moved == bool(gate_j)


@pytest.mark.parametrize("tile", [True, False])
@pytest.mark.parametrize("conditional", [True, False])
def test_five_step_trajectory_matches_jax(monkeypatch, tile, conditional):
    jg, tg, idx, rand_idx = _graph(SEED, tile)
    _freeze(monkeypatch, idx, rand_idx)
    jcfg, tcfg = _cfg(conditional)
    jm, params, tm = _models(jg)
    jopt = JDualOptimizer.create(params, jcfg.GNN, jcfg.lr, jcfg.weight_decay)
    jstate = jopt.init(params)
    jstep = jax_make_train_step(jcfg, jm, jopt, Q, max_epoch=5)
    topt = DualOptimizer.create(tm, tcfg.GNN, tcfg.lr, tcfg.weight_decay)
    tstep = make_train_step(tcfg, tm, topt, Q, max_epoch=5)
    gates_j, gates_t = [], []
    with jax.disable_jit():
        for ep in range(5):
            params, jstate, mj = jstep(params, jstate, jg, jnp.asarray(ep),
                                       jax.random.PRNGKey(100 + ep))
            mt = tstep(tg, ep, torch.Generator().manual_seed(100 + ep))
            # after the first edge-group step the parameters sit in the
            # lr-wide band (module docstring), and losses inherit ~1e-3
            assert abs(float(mt.loss) - float(mj.loss)) <= 2e-3 * max(
                1.0, abs(float(mj.loss))), ep
            assert mt.temperature == pytest.approx(float(mj.temperature))
            gates_j.append(bool(mj.conditional_update > 0.5))
            gates_t.append(bool(mt.conditional_update > 0.5))
    assert gates_t == gates_j, (gates_t, gates_j)
    if conditional:
        assert any(gates_j) and not all(gates_j), (
            f"gate sequence {gates_j} exercises one conditional branch only")
    else:
        assert all(gates_j)
    want = params_from_jax(_np_tree(params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=5 * tcfg.lr,
                                   err_msg=name)


def test_small_batch_step_matches_jax(monkeypatch):
    """E <= q: backbone CE on the full graph, gnn group only."""
    jg, tg, idx, rand_idx = _graph(4, False)
    jcfg, tcfg = _cfg(True)
    jm, params, tm = _models(jg)
    jopt = JDualOptimizer.create(params, "GCN", jcfg.lr, jcfg.weight_decay)
    jstate = jopt.init(params)
    topt = DualOptimizer.create(tm, "GCN", tcfg.lr, tcfg.weight_decay)
    with jax.disable_jit():
        params, _, mj = jax_make_train_step(jcfg, jm, jopt, E, 5)(
            params, jstate, jg, jnp.asarray(0), jax.random.PRNGKey(0))
    mt = make_train_step(tcfg, tm, topt, E, 5)(tg, 0, torch.Generator())
    np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=1e-5)
    want = params_from_jax(_np_tree(params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # every mode has a step (tests/test_torch_baselines.py holds the
    # baseline modes to the JAX package)
    for mode in ("random", "edge", "full"):
        assert callable(make_train_step(Config(mode=mode), tm, topt, Q, 5))
    # every pipeline of the learned mode is ported
    # (tests/test_torch_pipelines.py holds them to the JAX package)
    for pipeline in ("two_pass", "straight_through", "hybrid"):
        assert callable(make_learned_loss(Config(pipeline=pipeline), tm, Q))


# ------------------------------------------------------------------- eval


@pytest.mark.parametrize("small", [False, True])
def test_eval_step_matches_jax(monkeypatch, small):
    jg, tg, idx, rand_idx = _graph(4, False)
    _freeze(monkeypatch, idx, rand_idx)
    jcfg, tcfg = _cfg(True)
    jm, params, tm = _models(jg)
    q = E if small else Q
    res_j = jax_evaluate.make_eval_step(jcfg, jm, q)(
        params, jg, jax.random.PRNGKey(0), 0.5)
    res_t = make_eval_step(tcfg, tm, q)(tg, torch.Generator())
    assert set(res_t) == set(res_j)
    for k, v in res_t.items():
        np.testing.assert_allclose(float(v), float(res_j[k]), rtol=1e-5,
                                   err_msg=k)
    agg_t = aggregate_eval([res_t, res_t])
    agg_j = jax_evaluate.aggregate_eval([res_j, res_j])
    for k in agg_j:
        assert agg_t[k] == pytest.approx(agg_j[k], rel=1e-5)

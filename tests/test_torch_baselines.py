"""The baseline modes (random, edge, full) of the port's train step and
eval against the JAX package, on the CPU in f32.

As in ``tests/test_torch_train.py`` (whose graph and model helpers these
tests reuse): the same numpy inputs and flax weights go to both packages,
each package's ``random_edges`` and ``sample_prior_edges`` are replaced by
one fixed index set, dropout is off, and JAX runs eagerly under
``jax.disable_jit()``. Tolerances: values rtol 1e-5; gradients rtol 1e-4
with atol 1e-5 * max|grad| per tensor; parameters after one ``step_all``
update rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sgs_gnn_tpu.eval.evaluate as jax_evaluate
import sgs_gnn_tpu.train.pipelines as jax_pipelines
from sgs_gnn_tpu.core import Config as JConfig
from sgs_gnn_tpu.train.optim import DualOptimizer as JDualOptimizer

import sgs_gnn_tpu_torch.eval.evaluate as evaluate
import sgs_gnn_tpu_torch.train.pipelines as pipelines
from sgs_gnn_tpu_torch import (Config, DualOptimizer, make_eval_step,
                               make_train_step, params_from_jax)
from sgs_gnn_tpu_torch.train import make_baseline_loss

from test_torch_train import (E, Q, _grad_close, _graph, _models, _np_tree,
                              _t)

MODES = ("random", "edge", "full")


def _freeze(monkeypatch, idx):
    """Both packages' baseline samplers return ``idx``."""
    j_idx, t_idx = jnp.asarray(idx), _t(idx)
    for mod in (jax_pipelines, jax_evaluate):
        monkeypatch.setattr(mod, "random_edges", lambda *a, **k: j_idx)
        monkeypatch.setattr(mod, "sample_prior_edges", lambda *a, **k: j_idx)
    for mod in (pipelines, evaluate):
        monkeypatch.setattr(mod, "random_edges", lambda *a, **k: t_idx)
        monkeypatch.setattr(mod, "sample_prior_edges", lambda *a, **k: t_idx)


def _cfgs(mode):
    kw = dict(mode=mode, nhid=32, drop_rate=0.0, lr=0.01, donate=False,
              num_samples_eval=3)
    return JConfig(**kw), Config(**kw)


@pytest.mark.parametrize("force_small", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_baseline_loss_and_gradients_match_jax(monkeypatch, mode,
                                               force_small):
    jg, tg, idx, _ = _graph(4, False)
    _freeze(monkeypatch, idx)
    jcfg, tcfg = _cfgs(mode)
    jm, params, tm = _models(jg)
    with jax.disable_jit():
        loss_j, grads_j = jax.value_and_grad(jax_pipelines.make_baseline_loss(
            jcfg, jm, Q, force_small))(params, jg, jax.random.PRNGKey(0))
    loss_t = make_baseline_loss(tcfg, tm, Q, force_small)(
        tg, torch.Generator().manual_seed(0))
    names, tparams = zip(*tm.named_parameters())
    grads_t = torch.autograd.grad(loss_t, tparams, allow_unused=True)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = params_from_jax(_np_tree(grads_j))
    for name, g in zip(names, grads_t):
        g = np.zeros(want[name].shape) if g is None else g.numpy()
        _grad_close(g, want[name].numpy(), name)
    # the sampled modes see the q frozen edges unless forced small: the
    # losses of the sampled and the full graph differ
    full = make_baseline_loss(tcfg.replace(mode="full"), tm, Q)(
        tg, torch.Generator())
    sampled = mode != "full" and not force_small
    assert (float(full.detach()) != float(loss_t.detach())) == sampled


@pytest.mark.parametrize("mode", MODES)
def test_baseline_step_all_matches_jax(monkeypatch, mode):
    jg, tg, idx, _ = _graph(4, False)
    _freeze(monkeypatch, idx)
    jcfg, tcfg = _cfgs(mode)
    jm, params, tm = _models(jg)
    jopt = JDualOptimizer.create(params, "GCN", jcfg.lr, jcfg.weight_decay)
    jstate = jopt.init(params)
    topt = DualOptimizer.create(tm, "GCN", tcfg.lr, tcfg.weight_decay)
    with jax.disable_jit():
        jstep = jax_pipelines.make_train_step(jcfg, jm, jopt, Q, 5)
        for ep in range(2):
            params, jstate, mj = jstep(params, jstate, jg, jnp.asarray(ep),
                                       jax.random.PRNGKey(ep))
    tstep = make_train_step(tcfg, tm, topt, Q, 5)
    for ep in range(2):
        mt = tstep(tg, ep, torch.Generator().manual_seed(ep))
    np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=1e-5)
    assert mt.temperature == pytest.approx(float(mj.temperature))
    assert float(mt.conditional_update) == 0.0
    assert set(topt.state) == {"all"} and int(topt.state["all"].count) == 2
    want = params_from_jax(_np_tree(params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["learned"] + list(MODES))
def test_force_small_step_takes_the_whole_graph(monkeypatch, mode):
    """force_small on a graph with E > q: the step's loss is the whole
    graph's CE (JAX: force_small=True compiles the full-graph path)."""
    jg, tg, idx, rand_idx = _graph(4, False)
    _freeze(monkeypatch, idx)
    jcfg, tcfg = _cfgs(mode)
    jm, params, tm = _models(jg)
    jopt = JDualOptimizer.create(params, "GCN", jcfg.lr, jcfg.weight_decay)
    with jax.disable_jit():
        _, _, mj = jax_pipelines.make_train_step(
            jcfg, jm, jopt, Q, 5, force_small=True)(
            params, jopt.init(params), jg, jnp.asarray(0),
            jax.random.PRNGKey(0))
    topt = DualOptimizer.create(tm, "GCN", tcfg.lr, tcfg.weight_decay)
    mt = make_train_step(tcfg, tm, topt, Q, 5, force_small=True)(
        tg, 0, torch.Generator())
    np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=1e-5)
    assert set(topt.state) == {"gnn" if mode == "learned" else "all"}


@pytest.mark.parametrize("force_small", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_baseline_eval_matches_jax(monkeypatch, mode, force_small):
    jg, tg, idx, _ = _graph(4, False)
    _freeze(monkeypatch, idx)
    jcfg, tcfg = _cfgs(mode)
    jm, params, tm = _models(jg)
    res_j = jax_evaluate.make_eval_step(jcfg, jm, Q, force_small)(
        params, jg, jax.random.PRNGKey(0), 0.5)
    res_t = make_eval_step(tcfg, tm, Q, force_small)(tg, torch.Generator())
    assert set(res_t) == set(res_j)
    for k, v in res_t.items():
        np.testing.assert_allclose(float(v), float(res_j[k]), rtol=1e-5,
                                   err_msg=k)
    # E <= q: every mode evaluates the whole graph once
    res_e = make_eval_step(tcfg, tm, E)(tg, torch.Generator())
    full = make_eval_step(tcfg.replace(mode="full"), tm, Q)(
        tg, torch.Generator())
    for k in res_e:
        assert float(res_e[k]) == float(full[k]), k


@pytest.mark.parametrize("mode", ["random", "edge"])
def test_baseline_draws_stay_in_the_valid_edges(mode):
    """Unfrozen: every draw of q edges from a padded graph lands on valid
    edges, and the eval averages num_samples_eval distinct draws."""
    _, tg, _, _ = _graph(4, False)
    g = tg.__class__.build(
        tg.x.numpy(), np.stack([tg.senders.numpy(), tg.receivers.numpy()]),
        tg.y.numpy(), tg.train_mask.numpy(), tg.val_mask.numpy(),
        tg.test_mask.numpy(), prob=tg.prob.numpy(), num_classes=4,
        pad_edges_to=E + 300, pad_edge_node=0, device="cpu")
    seen = []
    real = pipelines.random_edges if mode == "random" \
        else pipelines.sample_prior_edges

    def spy(*a, **k):
        idx = real(*a, **k)
        seen.append(idx)
        return idx
    name = "random_edges" if mode == "random" else "sample_prior_edges"
    _, tcfg = _cfgs(mode)
    _, _, tm = _models(_graph(4, False)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluate, name, spy)
        make_eval_step(tcfg, tm, Q)(g, torch.Generator().manual_seed(1))
    assert len(seen) == tcfg.num_samples_eval
    assert len({tuple(s.tolist()) for s in seen}) == len(seen)
    for s in seen:
        assert bool(g.edge_mask[s.long()].all()) and len(set(s.tolist())) == Q

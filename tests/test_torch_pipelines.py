"""The learned mode's other pipelines (``two_pass``, ``straight_through``
and the exact ``hybrid`` with and without ``hybrid_checkpoint``) against
the JAX package, on the CPU in f32.

As in ``tests/test_torch_train.py``, whose graph, model and sampler-freezing
helpers these tests reuse: the same numpy inputs and flax weights go to
both packages, sampling is frozen to fixed indices with the weight formulas
of ``sample_edges`` (so straight_through's weights keep their gradient
path), dropout is off, and JAX's step runs eagerly under
``jax.disable_jit()``. Tolerances: values rtol 1e-5; gradients rtol 1e-4
with atol 1e-5 * max|grad| per tensor.
"""
import numpy as np
import pytest
import jax
import torch

from sgs_gnn_tpu.core import Config as JConfig
from sgs_gnn_tpu.train.pipelines import (
    make_learned_loss as jax_make_learned_loss)

from sgs_gnn_tpu_torch import Config, get_model
from sgs_gnn_tpu_torch.train.pipelines import make_learned_loss

from test_torch_train import (F_IN, HID, C, Q, _freeze, _grad_close, _graph,
                              _models, _np_tree)
from sgs_gnn_tpu_torch import params_from_jax

VARIANTS = {
    "two_pass": dict(pipeline="two_pass"),
    "straight_through": dict(pipeline="straight_through"),
    "hybrid_exact": dict(pipeline="hybrid", hybrid_rescore=False),
    "hybrid_exact_remat": dict(pipeline="hybrid", hybrid_rescore=False,
                               hybrid_checkpoint=True),
}


def _cfgs(variant, conditional):
    kw = dict(mode="learned", conditional=conditional, sparse_edge_mlp=True,
              reg1=True, reg2=True, nhid=HID, drop_rate=0.0, lr=0.01,
              donate=False, **VARIANTS[variant])
    return JConfig(**kw), Config(**kw)


@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_one_step_loss_gate_and_gradients_match_jax(monkeypatch, variant,
                                                    conditional):
    jg, tg, idx, rand_idx = _graph(4, False)
    assert tg.receiver_band > 0          # the banded route (K7 on a card)
    _freeze(monkeypatch, idx, rand_idx)
    jcfg, tcfg = _cfgs(variant, conditional)
    jm, params, tm = _models(jg)
    with jax.disable_jit():
        (loss_j, (gate_j, lf1_j, rf1_j)), grads_j = jax.value_and_grad(
            jax_make_learned_loss(jcfg, jm, Q), has_aux=True)(
            params, jg, jax.random.PRNGKey(0))
    loss_t, (gate_t, lf1_t, rf1_t) = make_learned_loss(tcfg, tm, Q)(
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
    scorer_moved = False
    for name, g in zip(names, grads_t):
        g = np.zeros(want[name].shape) if g is None else g.numpy()
        _grad_close(g, want[name].numpy(), name)
        scorer_moved |= name.startswith("edge_prob_mlp") and bool(
            np.abs(g).max() > 0)
    assert scorer_moved == bool(gate_j)


def test_hybrid_checkpoint_keeps_gradients_with_dropout():
    """With dropout on, ``hybrid_checkpoint`` (the head under
    ``torch.utils.checkpoint``) gives the same loss and gradients as the
    plain exact hybrid from the same generator seed: the recompute replays
    the forward's dropout mask, and the generator ends in the same state."""
    _, tg, _, _ = _graph(4, False)
    out = {}
    for remat in (False, True):
        cfg = Config(pipeline="hybrid", hybrid_rescore=False,
                     hybrid_checkpoint=remat, mode="learned",
                     conditional=True, sparse_edge_mlp=True, reg1=True,
                     reg2=True, nhid=HID, drop_rate=0.3)
        tm = get_model("GCN", F_IN, HID, C, cfg.drop_rate, "GCN",
                       device="cpu",
                       generator=torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(0)
        loss, _ = make_learned_loss(cfg, tm, Q)(tg, gen)
        grads = torch.autograd.grad(loss, list(tm.parameters()))
        out[remat] = (loss.detach(), grads, gen.get_state())
    (loss_a, grads_a, state_a), (loss_b, grads_b, state_b) = out[False], \
        out[True]
    assert torch.equal(loss_a, loss_b)
    assert any(bool(g.abs().max() > 0) for g in grads_a)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)
    assert torch.equal(state_a, state_b)

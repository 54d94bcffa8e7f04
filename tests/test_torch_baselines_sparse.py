"""The port's comparison baselines (``sgs_gnn_tpu_torch/baselines/``:
NeuralSparse's per-node Gumbel top-k, SparseGAT's L0 gates) against the
JAX package's, on the CPU in f32: the twins of ``tests/test_baselines.py``.

The same numpy graphs go to both packages and the flax weights are moved
by ``params_from_jax``. NeuralSparse draws its Gumbel noise inside the
forward: the port's draw (``neuralsparse.gumbel``) is replaced by JAX's
noise from the same key. SparseGAT is compared with ``deterministic=True``
(no gate draws, no dropout); its stochastic gates are held to JAX's by
distribution. Tolerances: the top-k mask exactly; values rtol = atol =
1e-5; gradients rtol 1e-4 with atol 1e-5 * max|grad| per tensor (the rule
of ``tests/test_torch_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.baselines import NeuralSparseGCN as JNeuralSparseGCN
from sgs_gnn_tpu.baselines import SparseGAT as JSparseGAT
from sgs_gnn_tpu.baselines import per_node_topk_mask as jax_topk_mask
from sgs_gnn_tpu.baselines.sparsegat import hard_concrete as jax_hard_concrete

from sgs_gnn_tpu_torch import params_from_jax
from sgs_gnn_tpu_torch.baselines import (NeuralSparseGCN, SparseGAT,
                                         l0_penalty, neuralsparse,
                                         per_node_topk_mask, sparsegat)

from test_torch_train import _grad_close, _np_tree
from test_train import _homophilous_graph

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def torch_defaults():
    """One intra-op thread (small CPU ops; parallel test workers share the
    cores) and float32 as the default dtype (another test module in the
    same worker sets float64 when it is imported)."""
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def _arrays(jg):
    """The port's tensors of a JAX graph: x, senders, receivers, y and the
    train mask."""
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jg.x, jg.senders, jg.receivers, jg.y, jg.train_mask))


def _ce(out, y, mask):
    """Masked mean cross-entropy (the JAX tests' loss)."""
    logp = torch.log_softmax(out, dim=-1)
    nll = -logp.gather(1, y.long()[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum() / m.sum()


def _jax_ce(out, g):
    logp = jax.nn.log_softmax(out)
    nll = -jnp.take_along_axis(logp, g.y[:, None], 1)[:, 0]
    m = g.train_mask.astype(jnp.float32)
    return jnp.sum(nll * m) / jnp.sum(m)


TOPK_CASES = {
    # test_baselines.py:11's case
    "normal": (10, 100, 3, lambda rng, e: rng.normal(size=e)),
    # ties everywhere: lexsort keeps equal keys in index order
    "tied": (10, 100, 3, lambda rng, e: rng.integers(0, 3, e)),
    "all_equal": (7, 60, 2, lambda rng, e: np.zeros(e)),
    "k1": (20, 150, 1, lambda rng, e: rng.normal(size=e).round(1)),
    "k_above_degree": (5, 30, 12, lambda rng, e: rng.normal(size=e)),
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_per_node_topk_mask_equals_jax(case):
    """The same mask as JAX's bit for bit, ties included; each receiver
    keeps min(k, in-degree) edges, its highest scores."""
    n, e, k, draw = TOPK_CASES[case]
    rng = np.random.default_rng(0)
    receivers = rng.integers(0, n, e).astype(np.int32)
    scores = draw(rng, e).astype(np.float32)
    want = np.asarray(jax_topk_mask(jnp.asarray(scores),
                                    jnp.asarray(receivers), n, k))
    got = per_node_topk_mask(torch.from_numpy(scores),
                             torch.from_numpy(receivers), n, k).numpy()
    np.testing.assert_array_equal(got, want)
    for node in range(n):
        idx = np.flatnonzero(receivers == node)
        assert got[idx].sum() == min(k, len(idx))
        if 0 < len(idx):
            kept = scores[idx[got[idx]]]
            assert kept.min() >= scores[idx[~got[idx]]].max(initial=-np.inf)


def _neuralsparse_pair(n=60):
    rng = np.random.default_rng(0)
    jg = _homophilous_graph(rng, n=n)
    jm = JNeuralSparseGCN(hidden_dim=16, num_classes=jg.num_classes, k=4)
    key = jax.random.PRNGKey(0)
    params = jm.init(key, jg.x, jg.senders, jg.receivers, key)
    tm = NeuralSparseGCN(jg.x.shape[1], 16, jg.num_classes, k=4,
                         device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    return jg, jm, params, tm, key


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_neuralsparse_matches_jax(monkeypatch, temperature):
    """The forward and every parameter gradient of a CE loss equal JAX's
    with JAX's Gumbel noise (``jax.random.gumbel(key, (E,))``, what the
    module draws from its key) fed to the port."""
    jg, jm, params, tm, key = _neuralsparse_pair()
    noise = np.asarray(jax.random.gumbel(key, (jg.num_edges,)))
    monkeypatch.setattr(neuralsparse, "gumbel",
                        lambda gen, shape, device: torch.tensor(noise))

    def jax_loss(p):
        out = jm.apply(p, jg.x, jg.senders, jg.receivers, key,
                       temperature=temperature, deterministic=True)
        return _jax_ce(out, jg), out

    (loss_j, out_j), grads_j = jax.value_and_grad(jax_loss,
                                                  has_aux=True)(params)
    x, s, r, y, tr = _arrays(jg)
    out_t = tm(x, s, r, torch.Generator(), temperature=temperature,
               deterministic=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    loss_t = _ce(out_t, y, tr)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    names, ps = zip(*tm.named_parameters())
    want = params_from_jax(_np_tree(grads_j))
    assert set(want) == set(names)
    for name, gr in zip(names, torch.autograd.grad(loss_t, ps)):
        _grad_close(gr.numpy(), want[name].numpy(), name)


def _sparsegat_pair(n=60):
    rng = np.random.default_rng(0)
    jg = _homophilous_graph(rng, n=n)
    jm = JSparseGAT(hidden_dim=16, num_classes=jg.num_classes)
    key = jax.random.PRNGKey(0)
    params = jm.init(key, jg.x, jg.senders, jg.receivers, key)
    tm = SparseGAT(jg.x.shape[1], jg.num_edges, 16, jg.num_classes,
                   device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    return jg, jm, params, tm, key


def test_sparsegat_matches_jax():
    """``(out, l0)`` and every parameter gradient of CE + 1e-3 * l0 / E
    (the JAX test's loss) equal JAX's with ``deterministic=True``; so do
    ``edge_weights`` and ``l0_penalty``."""
    jg, jm, params, tm, key = _sparsegat_pair()
    e = jg.num_edges

    def jax_loss(p):
        out, l0 = jm.apply(p, jg.x, jg.senders, jg.receivers, key,
                           deterministic=True)
        return _jax_ce(out, jg) + 1e-3 * l0 / e, (out, l0)

    (loss_j, (out_j, l0_j)), grads_j = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    x, s, r, y, tr = _arrays(jg)
    out_t, l0_t = tm(x, s, r, torch.Generator(), deterministic=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(float(l0_t.detach()), float(l0_j),
                               rtol=1e-6)
    loss_t = _ce(out_t, y, tr) + 1e-3 * l0_t / e
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    names, ps = zip(*tm.named_parameters())
    want = params_from_jax(_np_tree(grads_j))
    assert set(want) == set(names)
    for name, gr in zip(names, torch.autograd.grad(loss_t, ps)):
        _grad_close(gr.numpy(), want[name].numpy(), name)
    # shift the gates off their init so the clip bites at both ends
    la = np.linspace(-6.0, 6.0, e).astype(np.float32)
    p = jax.tree_util.tree_map(lambda a: a, params)
    p["params"]["log_alpha"] = jnp.asarray(la)
    np.testing.assert_allclose(
        SparseGAT.edge_weights({"log_alpha": torch.from_numpy(la)}).numpy(),
        np.asarray(JSparseGAT.edge_weights(p)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(l0_penalty(torch.from_numpy(la))),
        float(jax.jit(lambda v: jnp.sum(jax.nn.sigmoid(
            v - 0.66 * jnp.log(0.1 / 1.1))))(la)), rtol=1e-6)


def test_hard_concrete_stochastic_gates_match_jax_in_distribution():
    """The stochastic gates (``deterministic=False``) against JAX's draws:
    per log_alpha, the mean gate and the shares of closed (0) and open (1)
    gates of 40,000 draws agree within 0.01 (their sampling error is
    below 0.003); the deterministic gate is the clipped stretched sigmoid."""
    la = np.array([-3.0, -1.0, -0.2, 0.0, 0.4, 1.5, 3.0], np.float32)
    draws = 40_000
    gen = torch.Generator().manual_seed(0)
    got = torch.stack([sparsegat.hard_concrete(gen, torch.from_numpy(la),
                                               False)
                       for _ in range(draws)]).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    want = np.asarray(jax.vmap(lambda k: jax_hard_concrete(
        k, jnp.asarray(la), False))(keys))
    for stat in (lambda z: z.mean(0), lambda z: (z == 0).mean(0),
                 lambda z: (z == 1).mean(0)):
        np.testing.assert_allclose(stat(got), stat(want), atol=0.01)
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(
        sparsegat.hard_concrete(None, torch.from_numpy(la), True).numpy(),
        np.asarray(jax_hard_concrete(None, jnp.asarray(la), True)),
        rtol=1e-6, atol=1e-7)


def test_params_from_jax_moves_both_baselines():
    """``params_from_jax`` moves both flax trees unchanged onto the port's
    modules: the same names and shapes as their state dicts."""
    for pair in (_neuralsparse_pair(), _sparsegat_pair()):
        jg, jm, params, tm, key = pair
        moved = params_from_jax(_np_tree(params))
        assert {k: tuple(v.shape) for k, v in moved.items()} == {
            k: tuple(v.shape) for k, v in tm.state_dict().items()}


def _train(model, forward, tg, steps=25, lr=0.1):
    """``steps`` SGD steps of ``forward(generator) -> loss`` (the JAX
    tests' update), each from a generator seeded by the step; the
    losses."""
    losses = []
    for i in range(steps):
        loss = forward(torch.Generator().manual_seed(i))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        with torch.no_grad():
            for p, gr in zip(model.parameters(), grads):
                p -= lr * gr
        losses.append(float(loss.detach()))
    return losses


def test_neuralsparse_trains():
    """test_baselines.py:25's twin: 25 SGD steps (fresh Gumbel noise each)
    lower the loss."""
    rng = np.random.default_rng(0)
    jg = _homophilous_graph(rng, n=80)
    x, s, r, y, tr = _arrays(jg)
    model = NeuralSparseGCN(x.shape[1], 16, jg.num_classes, k=4,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))
    losses = _train(model, lambda gen: _ce(
        model(x, s, r, gen, deterministic=True), y, tr), jg)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_sparsegat_trains_and_sparsifies():
    """test_baselines.py:49's twin: 25 SGD steps of CE + 1e-3 * l0 / E
    with stochastic gates and dropout lower the loss, and the edge weights
    stay in [0, 1]. The L0 term's pull on each gate (1e-3 / E times a
    sigmoid slope, ~5e-7 here) is far below CE's, which moves the mean gate
    up or down with the draws (+6e-5 from seed 0, -3e-6 from seed 1), so
    the sparsifying pull is held against the same run without the L0 term,
    from the same weights and draws: it closes the gates (lower log_alpha
    on average)."""
    rng = np.random.default_rng(0)
    jg = _homophilous_graph(rng, n=60)
    x, s, r, y, tr = _arrays(jg)
    e = jg.num_edges
    log_alpha = {}
    for lam in (0.0, 1e-3):
        model = SparseGAT(x.shape[1], e, 16, jg.num_classes, device="cpu",
                          generator=torch.Generator().manual_seed(0))

        def loss(gen):
            out, l0 = model(x, s, r, gen, deterministic=False)
            return _ce(out, y, tr) + lam * l0 / e

        losses = _train(model, loss, jg)
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        w = SparseGAT.edge_weights(model.state_dict()).numpy()
        assert w.shape == (e,)
        assert (w >= 0).all() and (w <= 1).all()
        log_alpha[lam] = model.log_alpha.detach().double().numpy()
    assert (log_alpha[1e-3] - log_alpha[0.0]).mean() < 0


def test_baselines_run_on_the_card_unless_asked_for_the_cpu():
    """Like every entry point of the port, the baselines' default device
    is the card: without one they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="no card"):
        NeuralSparseGCN(4, 8, 2)
    with pytest.raises(RuntimeError, match="no card"):
        SparseGAT(4, 10, 8, 2)

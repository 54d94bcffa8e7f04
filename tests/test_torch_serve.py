"""The port's serving slice (``run/serve.py``) against the JAX package's,
on the CPU in f32: same graph, same parameters (moved by
``params_from_jax``). rtol = atol = 1e-5. The PRNG streams differ, so draws
are compared by distribution, and the backbone is compared on the JAX
draw."""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgs_gnn_tpu.core import Config as JConfig, Graph as JGraph
from sgs_gnn_tpu.data.priors import degree_prior as jax_degree_prior
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.run.serve import (make_predictor as jax_make_predictor,
                                   make_sparsifier as jax_make_sparsifier)

from sgs_gnn_tpu_torch import (Config, Graph, get_model, make_predictor,
                               make_sparsifier, params_from_jax)
from sgs_gnn_tpu_torch.ops.sampling_ops import gumbel_topk, uniform_topk
from sgs_gnn_tpu_torch.sparsify import (random_edges, sample_edges,
                                       sample_prior_edges)

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def slice_pair():
    rng = np.random.default_rng(7)
    n, e, f, c, hid = 60, 480, 8, 3, 16
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    train = rng.random(n) < 0.6
    prior = jax_degree_prior(s, r, n)
    kw = dict(prob=prior, num_classes=c, sort_by_receiver=True)
    jg = JGraph.build(x, np.stack([s, r]), y, train, ~train, None, **kw)
    tg = Graph.build(x, np.stack([s, r]), y, train, ~train, None,
                     device="cpu", **kw)
    jm = jax_get_model("GCN", f, hid, c, 0.3, "GCN")
    params = init_params(jm, jax.random.PRNGKey(0), jg.x, jg.senders,
                         jg.receivers)
    tm = get_model("GCN", f, hid, c, 0.3, "GCN", device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return dict(jg=jg, tg=tg, jm=jm, params=params, tm=tm, q=e // 4)


def test_sparsify_matches_jax(slice_pair):
    p = slice_pair
    q = p["q"]
    jsp = jax_make_sparsifier(JConfig(num_samples_eval=3), p["jm"], q)(
        p["params"], p["jg"], jax.random.PRNGKey(1))
    sp = make_sparsifier(Config(num_samples_eval=3), p["tm"], q)(
        p["tg"], torch.Generator().manual_seed(1))
    np.testing.assert_allclose(sp.probs.numpy(), np.asarray(jsp.probs), **TOL)
    assert sp.senders.shape == sp.receivers.shape == sp.weights.shape == (q,)
    assert sp.edge_ids.dtype == torch.int32
    assert len(set(sp.edge_ids.tolist())) == q       # without replacement
    np.testing.assert_array_equal(sp.weights.numpy(),
                                  sp.probs.numpy()[sp.edge_ids.numpy()])
    np.testing.assert_array_equal(
        sp.senders.numpy(), p["tg"].senders.numpy()[sp.edge_ids.numpy()])


def test_predict_full_graph_matches_jax(slice_pair):
    p = slice_pair
    q = p["tg"].num_edges                             # E <= q: no sampling
    jl, jlab = jax_make_predictor(JConfig(), p["jm"], q)(
        p["params"], p["jg"], jax.random.PRNGKey(2))
    tl, tlab = make_predictor(Config(), p["tm"], q)(
        p["tg"], torch.Generator().manual_seed(2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))


def test_backbone_on_jax_draw_matches_jax(slice_pair):
    p = slice_pair
    jsp = jax_make_sparsifier(JConfig(), p["jm"], p["q"])(
        p["params"], p["jg"], jax.random.PRNGKey(3))
    idx = torch.tensor(np.asarray(jsp.edge_ids))
    ref = p["jm"].apply(p["params"], p["jg"].x, jsp.senders, jsp.receivers,
                        jsp.weights, deterministic=True)
    tg = p["tg"]
    with torch.no_grad():
        out = p["tm"](tg.x, tg.senders[idx], tg.receivers[idx],
                      torch.tensor(np.asarray(jsp.weights)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_predict_sampled_is_mean_over_draws(slice_pair):
    p = slice_pair
    cfg = Config(num_samples_eval=3)
    tg, tm, q = p["tg"], p["tm"], p["q"]
    logits, labels = make_predictor(cfg, tm, q)(
        tg, torch.Generator().manual_seed(4))
    assert logits.shape == (tg.num_nodes, tg.num_classes)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        probs = tm.score_edges(tg.x, tg.senders, tg.receivers, tg.senders,
                               tg.receivers)
        outs = []
        for _ in range(cfg.num_samples_eval):
            idx, w = sample_edges(gen, probs, tg.prob, q,
                                  cfg.degree_bias_coef, istest=True,
                                  edge_mask=tg.edge_mask)
            outs.append(tm(tg.x, tg.senders[idx], tg.receivers[idx], w))
    np.testing.assert_allclose(logits.numpy(),
                               torch.stack(outs).mean(0).numpy(), **TOL)
    np.testing.assert_array_equal(labels.numpy(), logits.argmax(-1).numpy())


def _exact_inclusion(p, q):
    """P(item in sample) for q sequential draws without replacement with
    probability proportional to p (what Gumbel-top-k samples)."""
    p = np.asarray(p, np.float64) / np.sum(p)
    incl = np.zeros_like(p)
    for seq in itertools.permutations(range(len(p)), q):
        prob, left = 1.0, 1.0
        for i in seq:
            prob *= p[i] / left
            left -= p[i]
        incl[list(seq)] += prob
    return incl


def test_gumbel_topk_inclusion_matches_exact():
    probs = np.array([0.05, 0.1, 0.15, 0.2, 0.5, 1.0], np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    q, draws = 2, 4000
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(len(probs))
    for _ in range(draws):
        idx = gumbel_topk(gen, torch.from_numpy(probs), q,
                          mask=torch.from_numpy(mask))
        assert idx.dtype == torch.int32 and len(set(idx.tolist())) == q
        counts[idx.numpy()] += 1
    expect = np.zeros(len(probs))
    expect[mask] = _exact_inclusion(probs[mask], q)
    # binomial std <= sqrt(0.25 / 4000) ~ 0.008; 0.035 is over 4 std
    np.testing.assert_allclose(counts / draws, expect, atol=0.035)
    assert counts[~mask].sum() == 0


def test_prior_and_uniform_sampling_respect_mask():
    e, q = 30, 5
    mask = torch.arange(e) < 20
    gen = torch.Generator().manual_seed(5)
    for _ in range(10):
        idx = sample_prior_edges(gen, torch.ones(e), q, edge_mask=mask)
        idx2 = uniform_topk(gen, e, q, mask=mask, device="cpu")
        idx3 = random_edges(gen, e, q, edge_mask=mask)
        for i in (idx, idx2, idx3):
            assert i.dtype == torch.int32 and len(set(i.tolist())) == q
            assert bool((i < 20).all())
    with pytest.raises(ValueError, match="q=31"):
        uniform_topk(gen, e, e + 1, device="cpu")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sgs_gnn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sgs_gnn_tpu')]\n"
        "names = [m for m in sys.modules if m.startswith(p.__name__)]\n"
        "assert 'sgs_gnn_tpu_torch.train.pipelines' in names\n"
        "assert 'sgs_gnn_tpu_torch.eval.evaluate' in names\n"
        "assert 'sgs_gnn_tpu_torch.core.graphed' in names\n"
        "assert 'sgs_gnn_tpu_torch.ops.segment' in names\n"
        "assert 'sgs_gnn_tpu_torch.ops.gcn_norm' in names\n"
        "assert 'sgs_gnn_tpu_torch.ops.dense_graph' in names\n"
        "assert 'sgs_gnn_tpu_torch.utils.profiler' in names\n"
        "assert 'sgs_gnn_tpu_torch.utils.debug' in names\n"
        "assert 'sgs_gnn_tpu_torch.viz.curves' in names\n"
        "assert 'sgs_gnn_tpu_torch.parallel.partitioned' in names\n"
        "assert 'sgs_gnn_tpu_torch.parallel.halo_train' in names\n"
        "assert 'sgs_gnn_tpu_torch.parallel.tensor_parallel' in names\n"
        "assert 'sgs_gnn_tpu_torch.baselines.neuralsparse' in names\n"
        "assert 'sgs_gnn_tpu_torch.baselines.sparsegat' in names\n"
        "assert 'sgs_gnn_tpu_torch.viz.embeddings' in names\n"
        "assert 'sgs_gnn_tpu_torch.viz.graphs' in names\n"
        "for lib in ('matplotlib', 'sklearn', 'networkx'):\n"
        "    assert lib not in sys.modules, lib\n"
        "print(len(names))\n"
        "print(bad, file=sys.stderr)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.strip()) >= 50        # every submodule imported


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA entry points run")
    x = np.zeros((3, 2), np.float32)
    ei = np.array([[0, 1], [1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="no card"):
        Graph.build(x, ei, np.zeros(3, np.int32))     # default device: cuda
    with pytest.raises(RuntimeError, match="no card"):
        get_model("GCN", 2, 4, 2)

"""The ordered top-q draw (``ops/sampling_ops.py`` ``topq_ordered``) on the
CPU: the plain version's contract, the keys' formula, the generator stream
the draws consume, the hoisted per-distribution work of serving and the
eval. The kernel itself is held to the plain version by the card tests
(``tests/test_torch_cuda.py -k topq``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch import Config, Graph, get_model, make_predictor
from sgs_gnn_tpu_torch.eval import evaluate
from sgs_gnn_tpu_torch.ops import _build
from sgs_gnn_tpu_torch.ops import sampling_ops as so
from sgs_gnn_tpu_torch.sparsify import sampling
from sgs_gnn_tpu_torch.sparsify import (edge_sampler, random_edges,
                                        sample_edges, sample_prior_edges)
from sgs_gnn_tpu_torch.train import pipelines

# spans_off_after: autouse, one torch thread, float32 and the spans module
# off and empty around each test (an earlier test in the same worker may
# leave the default dtype at float64)
from test_torch_spans import spans_off_after  # noqa: F401

KINDS = ("gumbel", "uniform")
E_N, QN = 5000, 700


def _draw(kind, u, mask=None, logw=None):
    if kind == "gumbel" and logw is None:
        logw = so.log_weights(torch.rand(u.shape[0],
                                         generator=torch.Generator()
                                         .manual_seed(9)))
    return so.topq_ordered(u, QN, logw=logw if kind == "gumbel" else None,
                           mask=mask), logw


def _u(seed=0, n=E_N):
    """n distinct uniforms in (0, 1)."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    return (perm + 1).float() / (n + 1)


def _check_distinct(kind):
    u = _u()
    idx, logw = _draw(kind, u)
    keys = so.draw_keys(u, logw if kind == "gumbel" else None)
    assert keys.unique().numel() == E_N
    want = torch.topk(keys, QN).indices
    assert set(idx.tolist()) == set(want.tolist())


def _check_ascending(kind):
    idx, _ = _draw(kind, _u(1))
    assert idx.dtype == torch.int32 and idx.shape == (QN,)
    assert bool((idx[1:] > idx[:-1]).all())


def _check_ties(kind):
    # keys in 64 levels of ~78 entries: the threshold level is split, and
    # its lowest ids are the ones taken
    u = (torch.arange(E_N) % 64).float().add_(1.0).div_(128.0)
    logw = torch.zeros(E_N) if kind == "gumbel" else None
    idx = so.topq_ordered(u, QN, logw=logw)
    keys = so.draw_keys(u, logw)
    t = torch.topk(keys, QN).values.min()
    above = torch.nonzero(keys > t).flatten()
    tied = torch.nonzero(keys == t).flatten()
    assert tied.numel() > QN - above.numel() > 0
    want = torch.cat([above, tied[:QN - above.numel()]]).sort().values
    assert idx.tolist() == want.tolist()


def _check_masked(kind):
    mask = torch.rand(E_N, generator=torch.Generator().manual_seed(3)) < 0.4
    idx, _ = _draw(kind, _u(2), mask=mask)
    assert bool(mask[idx.long()].all())


def _check_all_valid(kind):
    mask = torch.zeros(E_N, dtype=torch.bool)
    mask[torch.randperm(E_N, generator=torch.Generator().manual_seed(4))
         [:QN]] = True
    idx, _ = _draw(kind, _u(3), mask=mask)
    assert idx.tolist() == torch.nonzero(mask).flatten().tolist()


def _check_too_many(kind):
    u = _u(4, n=QN - 1)
    with pytest.raises(ValueError, match=f"q={QN}"):
        so.topq_ordered(u, QN, logw=torch.zeros(QN - 1) if kind == "gumbel"
                        else None)


def _check_none(kind):
    u = _u(5)
    with pytest.raises(ValueError, match="q=0"):
        so.topq_ordered(u, 0, logw=torch.zeros(E_N) if kind == "gumbel"
                        else None)


CHECKS = {"same_set_as_topk": _check_distinct, "ascending": _check_ascending,
          "ties_to_lowest_ids": _check_ties, "masked_never": _check_masked,
          "q_equal_valid_takes_all": _check_all_valid,
          "q_above_e_raises": _check_too_many, "q_zero_raises": _check_none}


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_ordered_select(kind, check):
    CHECKS[check](kind)


def test_keys_are_the_old_formula_bit_for_bit():
    """The keys the kernel forms (``draw_keys``) equal the draw's old torch
    ops: u clamped in place, ``logp + -log(-log u)``, the mask's where."""
    gen = torch.Generator().manual_seed(7)
    probs = torch.rand(E_N, generator=gen) * 1e-3
    probs[:10] = 0.0
    u = torch.rand(E_N, generator=gen)
    u[:5] = 0.0
    mask = torch.rand(E_N, generator=gen) < 0.8
    old = torch.log(torch.clamp(probs, min=1e-30)) + -torch.log(
        -torch.log(u.clone().clamp_(min=torch.finfo(torch.float32).tiny)))
    old = torch.where(mask, old, float("-inf"))
    got = so.draw_keys(u, so.log_weights(probs), mask)
    assert torch.equal(got.view(torch.int32), old.view(torch.int32))
    old_u = torch.where(mask, u.clone().clamp_(
        min=torch.finfo(torch.float32).tiny), float("-inf"))
    assert torch.equal(so.draw_keys(u, None, mask).view(torch.int32),
                       old_u.view(torch.int32))


def _samplers(e, q):
    probs = torch.rand(e, generator=torch.Generator().manual_seed(1))
    prior = torch.rand(e, generator=torch.Generator().manual_seed(2))
    mask = torch.arange(e) < e - 7
    return {
        "sample_edges": lambda g: sample_edges(g, probs, prior, q, 0.3,
                                               edge_mask=mask),
        "sample_prior_edges": lambda g: sample_prior_edges(g, prior, q, mask),
        "random_edges": lambda g: random_edges(g, e, q, edge_mask=mask),
        "edge_sampler": lambda g, d=edge_sampler(probs, prior, q, 0.3, True,
                                                 mask): d(g),
    }


@pytest.mark.parametrize("sampler", ["sample_edges", "sample_prior_edges",
                                     "random_edges", "edge_sampler"])
def test_draws_consume_one_uniform_per_edge(sampler):
    """n draws leave the generator where n ``torch.rand((E,))`` calls do:
    the benchmark's reference replays that stream."""
    e, q, n = 900, 120, 3
    gen, ref = (torch.Generator().manual_seed(11) for _ in range(2))
    draw = _samplers(e, q)[sampler]
    for _ in range(n):
        draw(gen)
        torch.rand((e,), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


def test_edge_sampler_draws_equal_sample_edges():
    e, q = 900, 120
    probs = torch.rand(e, generator=torch.Generator().manual_seed(1))
    prior = torch.rand(e, generator=torch.Generator().manual_seed(2))
    draw = edge_sampler(probs, prior, q, 0.3, edge_mask=torch.arange(e) < 800)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    for _ in range(3):
        i1, w1 = draw(g1)
        i2, w2 = sample_edges(g2, probs, prior, q, 0.3,
                              edge_mask=torch.arange(e) < 800)
        assert torch.equal(i1, i2) and torch.equal(w1, w2)


def _graph(n=60, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, (2, e)).astype(np.int32)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    train = rng.random(n) < 0.5
    return Graph.build(x, np.stack([s, r]), y, train, ~train, None,
                       num_classes=3, sort_by_receiver=True, device="cpu")


@pytest.mark.parametrize("where", ["predict", "eval"])
def test_the_distribution_work_runs_once_per_scoring(monkeypatch, where):
    """Serving and the learned eval normalise and take the log of the
    probabilities once for their num_samples_eval draws."""
    g = _graph()
    cfg = Config(num_samples_eval=4, nhid=8)
    model = get_model("GCN", 12, 8, 3, 0.0, device="cpu")
    calls = []
    real = sampling.log_weights

    def counted(p):
        calls.append(p.shape)
        return real(p)
    monkeypatch.setattr(sampling, "log_weights", counted)
    routes0 = dict(_build.ROUTES)
    gen = torch.Generator().manual_seed(0)
    if where == "predict":
        make_predictor(cfg, model, 500)(g, gen)
    else:
        evaluate.make_eval_step(cfg, model, 500)(g, gen)
    assert calls == [(g.num_edges,)]
    assert _build.ROUTES["topq", "gumbel"] - routes0.get(
        ("topq", "gumbel"), 0) == cfg.num_samples_eval


def test_the_pipelines_keep_the_draws_order():
    """``_sample_sorted`` returns the draw as drawn: ascending ids, the
    receivers named as the head's sorted side."""
    g = _graph()
    cfg = Config(sorted_head="on")
    probs = torch.rand(g.num_edges, generator=torch.Generator().manual_seed(3))
    gen, ref = (torch.Generator().manual_seed(8) for _ in range(2))
    idx, side = pipelines._sample_sorted(cfg, g, gen, probs, 400)
    want, _ = sample_edges(ref, probs, g.prob, 400, cfg.degree_bias_coef,
                           edge_mask=g.edge_mask)
    assert side == "receivers" and torch.equal(idx, want)
    r = g.receivers[idx.long()]
    assert bool((r[1:] >= r[:-1]).all())

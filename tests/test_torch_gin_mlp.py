"""The GIN backbone with the MLP scorer through the port's serving and eval
paths, against the JAX package on the CPU in f32, and what the port
records of GIN's neighbour sums.

  * ``run/serve.py`` ``make_predictor``'s logits and ``eval/evaluate.py``
    ``make_eval_step``'s outputs equal the JAX package's on the same
    parameters (``params_from_jax``), with both packages' samplers frozen
    to one draw as ``tests/test_torch_train.py`` freezes them, and on the
    whole graph (E <= q).
  * ``ops/spmm.py`` counts the message matrix each call of the gather
    route writes, E x F x itemsize, in ``BYTES[("spmm", "gather_k1")]``
    (``kernels.bytes.spmm.gather_k1`` in ``core/spans.collect``), and
    nothing on K8's route; a graph's capture keeps the bytes as its tally
    and each replay adds them back once.
  * ``GINConv`` stamps its sum as the segment ``aggregate`` of the phase
    it runs in (the work before it as ``backbone``), and the graphed
    epoch, eval and ``predict`` of GIN + MLP give the same outputs, bit
    for bit, with the stamps on and off. (On the CPU a stamp launches
    nothing; ``tests/test_torch_cuda.py`` holds the card's stamps.)
"""
import collections
import importlib

import numpy as np
import pytest
import jax
import torch

import sgs_gnn_tpu.eval.evaluate as jax_evaluate
import sgs_gnn_tpu.run.serve as jax_serve
from sgs_gnn_tpu.core import Config as JConfig
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.sparsify.sampling import _normalized as jax_normalized

import sgs_gnn_tpu_torch.eval.evaluate as evaluate
from sgs_gnn_tpu_torch import (Config, DualOptimizer, get_model,
                               make_eval_step, make_predictor,
                               params_from_jax)
from sgs_gnn_tpu_torch.core import graphed, spans
from sgs_gnn_tpu_torch.eval import make_scan_eval_step
from sgs_gnn_tpu_torch.models.layers import GINConv
from sgs_gnn_tpu_torch.ops import _build
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.sparsify.sampling import (
    _normalized as torch_normalized)
from sgs_gnn_tpu_torch.train import make_scan_epoch_step

from test_torch_graphed import _FakeGraph, _no_capture
# spans_off_after: autouse, one torch thread, float32 and the spans module
# off and empty around each test
from test_torch_spans import _rerun_capture, spans_off_after  # noqa: F401
from test_torch_train import (C, E, F_IN, HID, Q, _cfg, _freeze, _graph,
                              _np_tree, _t, edge_sampler_of)

# the module (ops/__init__ binds the name spmm to the function)
sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
KEY = ("spmm", "gather_k1")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _gin_models(jg, init_seed=5):
    jm = jax_get_model("GIN", F_IN, HID, C, 0.0, "MLP")
    params = init_params(jm, jax.random.PRNGKey(init_seed), jg.x,
                         jg.senders, jg.receivers)
    tm = get_model("GIN", F_IN, HID, C, 0.0, "MLP", device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    return jm, params, tm


def _freeze_serving(monkeypatch, idx):
    """Both packages' serving samplers (the port's: the learned
    ensemble's ``edge_sampler``, in ``eval/evaluate.py``) return the edges
    ``idx`` with the straight-through weights of ``sample_edges``
    (evaluation semantics)."""
    j_idx, t_idx = jax.numpy.asarray(idx), _t(idx)

    def jax_sample_edges(key, edge_probs, prior, q, beta, istest=False,
                         edge_mask=None, approx=False, bf16=True):
        sel = jax_normalized(edge_probs, edge_mask)[j_idx]
        st = jax.lax.stop_gradient(1.0 - sel) + sel
        return j_idx, jax.numpy.clip(edge_probs[j_idx] * st, 0.0, 1.0)

    def torch_sample_edges(generator, edge_probs, prior, q, beta,
                           istest=False, edge_mask=None):
        sel = torch_normalized(edge_probs, edge_mask)[t_idx.long()]
        st = (1.0 - sel).detach() + sel
        return t_idx, torch.clamp(edge_probs[t_idx.long()] * st, 0.0, 1.0)
    monkeypatch.setattr(jax_serve, "sample_edges", jax_sample_edges)
    monkeypatch.setattr(evaluate, "edge_sampler",
                        edge_sampler_of(torch_sample_edges))


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("whole", [False, True], ids=["sampled", "whole"])
def test_predictor_matches_jax(monkeypatch, whole):
    jg, tg, idx, _ = _graph(4, False)
    _freeze_serving(monkeypatch, idx)
    jm, params, tm = _gin_models(jg)
    q = E if whole else Q
    cfg = dict(num_samples_eval=3)
    jl, jlab = jax_serve.make_predictor(JConfig(**cfg), jm, q)(
        params, jg, jax.random.PRNGKey(2))
    tl, tlab = make_predictor(Config(**cfg), tm, q)(
        tg, torch.Generator().manual_seed(2))
    _close(tl.numpy(), np.asarray(jl), "logits")
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))


@pytest.mark.parametrize("small", [False, True])
def test_eval_step_matches_jax(monkeypatch, small):
    jg, tg, idx, rand_idx = _graph(4, False)
    _freeze(monkeypatch, idx, rand_idx)
    jcfg, tcfg = _cfg(True)
    jcfg = jcfg.replace(GNN="GIN", edge_mlp_type="MLP")
    tcfg = tcfg.replace(GNN="GIN", edge_mlp_type="MLP")
    jm, params, tm = _gin_models(jg)
    q = E if small else Q
    res_j = jax_evaluate.make_eval_step(jcfg, jm, q)(
        params, jg, jax.random.PRNGKey(0), 0.5)
    res_t = make_eval_step(tcfg, tm, q)(tg, torch.Generator())
    assert set(res_t) == set(res_j)
    for k, v in res_t.items():
        np.testing.assert_allclose(float(v), float(res_j[k]), rtol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------ the bytes counter

def _edges(n, e, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, n, (e,), generator=g, dtype=torch.int32),
            torch.randint(0, n, (e,), generator=g, dtype=torch.int32))


@pytest.mark.parametrize("dtype,weighted", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False)])
def test_the_gather_route_counts_its_message_matrix(dtype, weighted):
    n, e, f = 40, 333, 7
    s, r = _edges(n, e)
    x = torch.randn(n, f).to(dtype)
    w = torch.rand(e) if weighted else None
    before = collections.Counter(_build.BYTES)
    routes = collections.Counter(_build.ROUTES)
    sp.spmm(s, r, w, x, n)
    assert _build.ROUTES - routes == {KEY: 1}
    assert _build.BYTES - before == {KEY: e * f * x.element_size()}


def test_the_k8_route_counts_no_message_bytes(monkeypatch):
    monkeypatch.setattr(sp, "auto_route", lambda *a: "k8_tiles")
    n, e, f = 40, 333, 16
    s, r = _edges(n, e, 1)
    x = torch.randn(n, f).to(torch.bfloat16)
    before = collections.Counter(_build.BYTES)
    routes = collections.Counter(_build.ROUTES)
    sp.spmm(s, r, None, x, n)
    assert _build.ROUTES - routes == {("spmm", "k8_tiles"): 1}
    assert _build.BYTES == before


def test_capture_moves_the_message_bytes_into_the_tally():
    n, e, f = 30, 200, 5
    s, r = _edges(n, e, 2)
    x = torch.randn(n, f)

    def body():
        sp.spmm(s, r, None, x, n)
        return sp.spmm(s, r, None, x[:, :3].contiguous(), n)
    before = collections.Counter(_build.BYTES)
    cap = graphed.capture(body, graph=_FakeGraph(), context=_no_capture)
    assert _build.BYTES == before            # a capture runs nothing
    assert cap.nbytes == {KEY: e * (f + 3) * 4}
    for k in (1, 2, 3):
        cap.replay()
        assert _build.BYTES - before == {KEY: k * e * (f + 3) * 4}


def test_collect_reports_the_bytes_since_the_reset():
    n, e, f = 30, 200, 5
    s, r = _edges(n, e, 3)
    sp.spmm(s, r, None, torch.randn(n, f), n)
    spans.reset()
    assert "kernels.bytes.spmm.gather_k1" not in spans.collect()["counters"]
    sp.spmm(s, r, None, torch.randn(n, f), n)
    sp.spmm(s, r, None, torch.randn(n, f), n)
    assert spans.collect()["counters"]["kernels.bytes.spmm.gather_k1"] == \
        2 * e * f * 4


# ------------------------------------------------------------- the stamps

@pytest.fixture
def stamp_log(monkeypatch):
    """Spans off and empty before and after; the names each stamp would
    launch, recorded (a CPU stamp launches nothing)."""
    spans.disable()
    spans.reset()
    names = []
    real = spans._launch
    monkeypatch.setattr(spans, "_launch",
                        lambda name, device: (names.append(name),
                                              real(name, device)))
    yield names
    spans.disable()
    spans.reset()


def test_gin_conv_stamps_its_sum_as_aggregate(stamp_log):
    n, e = 30, 200
    s, r = _edges(n, e, 4)
    conv = GINConv(6, 8, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(n, 6)
    off = conv(x, s, r)
    assert stamp_log == []
    spans.enable(device_stamps=True)
    with spans.phase("serve"):
        on = conv(x, s, r)
    assert stamp_log == ["serve.backbone", "serve.aggregate"]
    assert torch.equal(on, off)


BASE = dict(dataset="SyntheticSBM", metis_threshold=20000, shape_classes=2,
            nhid=16, runs=1, num_samples_eval=3, GNN="GIN",
            edge_mlp_type="MLP", mode="learned", pipeline="hybrid",
            conditional=True, reg1=True, reg2=True, sparse_edge_mlp=True)


@pytest.fixture(scope="module")
def parts():
    """4 partitions in 2 shape classes; a skipped, a small and two sampled
    batches, q below every sampled batch's valid edges."""
    from sgs_gnn_tpu_torch.data import registry
    cfg = Config(**BASE)
    batches, _, _ = driver.prepare_batches(cfg, registry.get_dataset(cfg),
                                           "cpu")
    valid = [int(g.edge_mask.sum()) for g in batches]
    plan = [0, 1, 2, 2]
    q = min(v for v, a in zip(valid, plan) if a == 2) // 3
    return batches, plan, q, registry.get_dataset(cfg).num_classes


def _model(cfg, batches, classes, seed=1):
    return get_model("GIN", batches[0].x.shape[1], cfg.nhid, classes,
                     cfg.drop_rate, "MLP", device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _graphed_run(parts):
    """Two graphed learned epochs with an eval after each, then three
    ``predict`` calls (fake capture): every output and the parameters."""
    batches, plan, q, classes = parts
    cfg = Config(**BASE)
    tm = _model(cfg, batches, classes)
    opt = DualOptimizer.create(tm, "GIN", cfg.lr, cfg.weight_decay)
    pool = graphed.ShapeClasses(new_pool=lambda: None)
    steps = make_scan_epoch_step(cfg, tm, opt, q, 3, len(batches), pool)
    evals = make_scan_eval_step(cfg, tm, q, pool)
    steps.graphs = graphed.Graphs(_rerun_capture, name="step")
    evals.graphs = graphed.Graphs(_rerun_capture, name="eval")
    gen = torch.Generator()
    out = []
    for epoch in range(2):
        out += list(steps(batches, [3, 0, 1, 2], plan, epoch, gen,
                          lambda n: driver.batch_seed(0, 0, n)))
        res = evals(batches, [1, 0, 1, 0], gen, 7 + epoch)
        out += [torch.as_tensor(res[k]) for k in sorted(res)]
    predict = make_predictor(cfg, tm, q)
    for i, s in ((2, 1), (3, 2), (2, 1)):
        out += list(predict(batches[i], gen.manual_seed(s)))
    return out + [p.detach().clone() for p in tm.parameters()]


def test_graphed_gin_mlp_is_the_same_with_stamps_on(parts, stamp_log,
                                                    monkeypatch):
    monkeypatch.setattr(graphed, "runs_graphs", lambda device: True)
    monkeypatch.setattr(graphed, "capture", _rerun_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    off = _graphed_run(parts)
    assert stamp_log == []
    spans.enable(device_stamps=True)
    on = _graphed_run(parts)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    seen = collections.Counter(stamp_log)
    for phase in ("step", "eval", "serve"):
        # each GIN layer's sum: a backbone stamp before it, an aggregate
        # stamp after it
        assert seen[f"{phase}.aggregate"] > 0, phase
        assert seen[f"{phase}.aggregate"] % 2 == 0, phase
        assert seen[f"{phase}.backbone"] >= seen[f"{phase}.aggregate"]

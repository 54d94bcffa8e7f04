"""GCNII (``models/backbones.py`` ``GCNIIModel``, ``models/layers.py``
``GCN2Conv``) through the port's normal paths on the CPU, against the
benchmark's plain reference (``benchmark/archs/backbone_GCNII.py``; the
JAX package has no GCNII):

  * the forward equals the reference on the same seeded weights
    (``benchmark.reference.make_weights``), weighted and unweighted, in
    float32 within 1e-5 and in bfloat16 within ``BF16_GAP``, at a reduced
    depth and width and once at the published 9 x 2048 on a graph of 20
    nodes; with dropout off every backbone gradient, the edge weights'
    included, equals autograd through the reference;
  * ``run/driver.py`` trains two learned epochs and ``run/serve.py``
    ``make_predictor`` serves the trained model; the optimizer's ``gnn``
    group holds exactly GCNII's parameters;
  * the halo exchange, tensor parallelism and ``dense_subgraph='on'``
    refuse GCNII by name;
  * each propagation is stamped ``aggregate`` (``backbone`` before it),
    and the graphed epoch, eval and ``predict`` give the same outputs bit
    for bit with the stamps on and off;
  * ``GCNConv`` on the shared normalisation (``gcn_propagate``) gives the
    outputs and gradients of its formula before the helper, bit for bit.
"""
import collections
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import archs
from benchmark import reference as R
from sgs_gnn_tpu_torch import Config, DualOptimizer, make_predictor
from sgs_gnn_tpu_torch.core import graphed, spans
from sgs_gnn_tpu_torch.data import registry as treg
from sgs_gnn_tpu_torch.eval import make_scan_eval_step
from sgs_gnn_tpu_torch.models import backbones
from sgs_gnn_tpu_torch.models.backbones import GCNIIModel
from sgs_gnn_tpu_torch.models.layers import (GCN2Conv, GCNConv, col_shard,
                                             linear)
from sgs_gnn_tpu_torch.ops.dense_graph import (DenseEdges, dense_adj,
                                               use_dense_subgraph)
from sgs_gnn_tpu_torch.ops.scatter import segment_sum_scalar
from sgs_gnn_tpu_torch.ops.spmm import spmm
from sgs_gnn_tpu_torch.parallel.halo_train import halo_gnn_forward
from sgs_gnn_tpu_torch.parallel.tensor_parallel import shard_params_tp
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.train import make_scan_epoch_step

# spans_off_after: autouse, one torch thread, float32 and the spans module
# off and empty around each test
from test_torch_spans import _rerun_capture, spans_off_after  # noqa: F401
from test_torch_parallel import one_rank_group, partitions  # noqa: F401

REF_CFG = dict(GNN="GCNII", edge_mlp_type="GCN", drop_rate=0.3)
BB = archs.backbone(REF_CFG)
# bf16 against the reference rounded at bf16: the port also rounds the
# degree factor before it scales the rows and each propagation's sum to
# bf16 (spmm's output), which the reference leaves in f32. Max |logit
# error| over the logits' rms read 0.0078-0.0151 (4 layers) and
# 0.0067-0.0168 (9 x 2048) on three graphs each; the limit is three times
# the largest
BF16_GAP = 0.05


def _graph(n, e, f, seed):
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
    r = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
    return (torch.randn(n, f, generator=g), s, r,
            torch.rand(e, generator=g))


def _models(f, c, dtype, seed, monkeypatch, **kw):
    """The port's GCNII and the reference's on one set of weights."""
    port = GCNIIModel(f, 8, c, 0.3, "GCN", dtype=dtype, **kw)
    shapes = {k: tuple(p.shape) for k, p in port.named_parameters()}
    w = R.make_weights(shapes, seed, "cpu")
    with torch.no_grad():
        for k, p in port.named_parameters():
            p.copy_(w[k])
    monkeypatch.setattr(BB, "LAYERS", port.num_layers)
    pr = R.F32 if dtype == torch.float32 else R.Precision(dtype)
    ref = R.Model(REF_CFG, {k: v.clone() for k, v in w.items()}, pr)
    return port, ref


def _gap(got, want):
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


SMALL = dict(layers=4, width=24)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["reduced", "published"])
def test_forward_matches_the_reference(monkeypatch, weighted, dtype, shape):
    n, e, f, c = (40, 300, 12, 5) if shape == "reduced" else (20, 60, 12, 5)
    kw = SMALL if shape == "reduced" else {}
    x, s, r, w = _graph(n, e, f, 3)
    w = w if weighted else None
    port, ref = _models(f, c, dtype, 11, monkeypatch, **kw)
    if shape == "published":
        assert (port.num_layers, port.GCNII_conv1.lin.weight.shape[0]) \
            == (BB.LAYERS, 2048)
    with torch.no_grad():
        got = port(x, s, r, w)
        want = ref.forward(x, s, r, w, n, None)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        assert _gap(got, want) < BF16_GAP


def test_backward_matches_autograd_through_the_reference(monkeypatch):
    n, e, f, c = 30, 200, 10, 4
    x, s, r, w0 = _graph(n, e, f, 5)
    port, ref = _models(f, c, torch.float32, 7, monkeypatch, layers=3,
                        width=16)
    proj = torch.randn(n, c, generator=torch.Generator().manual_seed(9))
    w_port = w0.clone().requires_grad_(True)
    (port(x, s, r, w_port) * proj).sum().backward()
    P = {k: v.requires_grad_(True) for k, v in ref.P.items()}
    w_ref = w0.clone().requires_grad_(True)
    (ref.forward(x, s, r, w_ref, n, None) * proj).sum().backward()
    names = [k for k, _ in port.named_parameters() if "GCNII" in k]
    assert len(names) == 2 + 2 + 3
    for k, p in port.named_parameters():
        if "GCNII" in k:
            np.testing.assert_allclose(p.grad.numpy(), P[k].grad.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            assert p.grad is None, k        # the scorer takes no part
    np.testing.assert_allclose(w_port.grad.numpy(), w_ref.grad.numpy(),
                               rtol=1e-4, atol=1e-6)


def test_beta_and_the_layer_names():
    m = GCNIIModel(6, 4, 3, **SMALL)
    assert [conv.beta for conv in m.convs()] == pytest.approx(
        [np.log(1.0 / k + 1.0) for k in range(1, 5)])
    names = [k for k, _ in m.named_parameters()]
    assert [k for k in names if "GCNII" in k] == [
        "GCNII_in.weight", "GCNII_in.bias"] + [
        f"GCNII_conv{k}.lin.weight" for k in range(1, 5)] + [
        "GCNII_out.weight", "GCNII_out.bias"]
    assert all(k.startswith("edge_prob_mlp") for k in names
               if "GCNII" not in k)


# ------------------------------------------------------------- the driver

BASE = dict(dataset="SyntheticSBM", metis_threshold=20000, shape_classes=2,
            nhid=16, runs=1, num_samples_eval=3, GNN="GCNII",
            edge_mlp_type="GCN", mode="learned", pipeline="hybrid",
            conditional=True, reg1=True, reg2=True, sparse_edge_mlp=True)


@pytest.fixture
def narrow(monkeypatch):
    """GCNII 3 layers of 24 columns wherever the port builds it."""
    monkeypatch.setitem(backbones.BACKBONES, "GCNII", functools.partial(
        GCNIIModel, layers=3, width=24))


def test_the_driver_trains_and_serves_gcnii(monkeypatch, narrow):
    models, opts = [], []
    init = driver.init_model

    def capture(*a, **k):
        models.append(init(*a, **k))
        models.append({n: p.detach().clone()
                       for n, p in models[-1].named_parameters()})
        return models[0]

    class Recording(DualOptimizer):
        @staticmethod
        def create(*a, **k):
            opts.append(DualOptimizer.create(*a, **k))
            return opts[-1]
    monkeypatch.setattr(driver, "init_model", capture)
    monkeypatch.setattr(driver, "DualOptimizer", Recording)
    cfg = Config(epochs=2, save_csv=False, **BASE)
    ds = treg.get_dataset(cfg)
    (res,) = driver.run_experiment(cfg, ds, log_fn=lambda *a: None,
                                   device="cpu")
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert res.total_updates > 0
    model, before = models
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert any("GCNII" in n for n in moved)
    (opt,) = opts
    gnn = [n for n, k in zip(opt.names, opt.masks["gnn"]) if k]
    assert gnn == [n for n, _ in model.named_parameters() if "GCNII" in n]
    assert not any("edge_prob_mlp" in n for n in gnn)
    batches, q, _ = driver.prepare_batches(cfg, ds, "cpu")
    predict = make_predictor(cfg, model, q)
    logits, labels = predict(batches[-1], torch.Generator().manual_seed(3))
    assert logits.shape == (batches[-1].num_nodes, ds.num_classes)
    assert bool(torch.isfinite(logits).all())


def test_a_one_rank_super_step_is_the_sequential_step(one_rank_group):
    """The data-parallel step of one rank (its all-reduces the identity)
    trains GCNII as the sequential step does, bit for bit."""
    from sgs_gnn_tpu_torch.parallel import (init_distributed,
                                            make_parallel_train_step,
                                            rank_seed)
    from sgs_gnn_tpu_torch.train import pipelines
    mesh = init_distributed(device="cpu")
    g = partitions(2)[0]
    cfg = Config(pipeline="hybrid", mode="learned", nhid=16, reg1=True,
                 reg2=True, conditional=True, GNN="GCNII")
    q = int(g.edge_mask.sum()) // 2
    models = [GCNIIModel(g.x.shape[1], 16, 4, cfg.drop_rate, "GCN",
                         generator=torch.Generator().manual_seed(0),
                         layers=3, width=24) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    before = {k: v.clone() for k, v in models[0].state_dict().items()}
    opts = [DualOptimizer.create(m, "GCNII", cfg.lr, cfg.weight_decay)
            for m in models]
    par = make_parallel_train_step(cfg, models[0], opts[0], q, 5, mesh)
    seq = pipelines.make_train_step(cfg, models[1], opts[1], q, 5)
    for ep in range(2):
        mp = par(g, ep, 40 + ep, torch.Generator())
        ms = seq(g, ep, torch.Generator().manual_seed(rank_seed(40 + ep, 0)))
        assert float(mp.loss) == float(ms.loss)
        assert bool(torch.isfinite(mp.loss))
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k
    assert not torch.equal(before["GCNII_conv1.lin.weight"],
                           models[0].GCNII_conv1.lin.weight)


# --------------------------------------------------- the routes it refuses

def test_the_halo_exchange_refuses_gcnii():
    m = GCNIIModel(6, 4, 3, **SMALL)
    x, s, r, w = _graph(10, 30, 6, 1)
    hb = SimpleNamespace(x=x, exchange=lambda t: t)
    with pytest.raises(NotImplementedError, match="GCNII"):
        halo_gnn_forward(m, hb, s, r, w, torch.ones(30, dtype=torch.bool))


def test_tensor_parallelism_refuses_gcnii():
    m = GCNIIModel(6, 4, 3, **SMALL)
    with pytest.raises(NotImplementedError, match="GCNII"):
        shard_params_tp(m, mesh=None)


def test_tensor_parallelism_refuses_a_parameter_no_spec_covers():
    """The refusal is by parameter, not by model: a layer that is neither
    column- nor row-sharded nor run whole is named, and nothing changes."""
    m = backbones.GNNModel(6, 4, 3, edge_mlp_type="GCN")
    m.extra = torch.nn.Parameter(torch.zeros(4))
    before = {k: p.clone() for k, p in m.named_parameters()}
    with pytest.raises(NotImplementedError, match="parameter extra"):
        shard_params_tp(m, mesh=None)
    assert all(torch.equal(p, before[k]) for k, p in m.named_parameters())


def test_every_backbone_enters_through_one_forward():
    """GCNII overrides the layer stack, not ``forward``: a wrapper of
    ``_Backbone.forward`` sees every backbone's logits."""
    for cls in backbones.BACKBONES.values():
        assert cls.forward is backbones._Backbone.forward
    m = GCNIIModel(6, 4, 3, **SMALL)
    x, s, r, w = _graph(10, 30, 6, 1)
    with torch.no_grad():
        want = m(x, s, r, w)
        got = m.stack(x, s, r, w, False, None, None, None)
    assert torch.equal(got, want)


def test_the_dense_route_refuses_gcnii():
    with pytest.raises(ValueError, match="GCNII"):
        Config(GNN="GCNII", dense_subgraph="on").validate()
    cfg = Config(GNN="GCNII", dense_subgraph="auto")
    cfg.validate()
    assert not use_dense_subgraph(cfg, 50, 400, "cpu")


# ------------------------------------------------------------- the stamps

@pytest.fixture
def stamp_log(monkeypatch):
    """The names each stamp would launch (a CPU stamp launches nothing)."""
    names = []
    real = spans._launch
    monkeypatch.setattr(spans, "_launch",
                        lambda name, device: (names.append(name),
                                              real(name, device)))
    return names


def test_gcn2conv_stamps_its_propagation_as_aggregate(stamp_log):
    x, s, r, w = _graph(30, 200, 8, 4)
    conv = GCN2Conv(8, 2, 0.5, 1.0,
                    generator=torch.Generator().manual_seed(0))
    h0 = torch.randn(30, 8)
    off = conv(x, h0, s, r, w)
    assert stamp_log == []
    spans.enable(device_stamps=True)
    with spans.phase("serve"):
        on = conv(x, h0, s, r, w)
    assert stamp_log == ["serve.backbone", "serve.aggregate"]
    assert torch.equal(on, off)


@pytest.fixture(scope="module")
def parts():
    """4 partitions in 2 shape classes; a skipped, a small and two sampled
    batches, q below every sampled batch's valid edges."""
    cfg = Config(**BASE)
    ds = treg.get_dataset(cfg)
    batches, _, _ = driver.prepare_batches(cfg, ds, "cpu")
    valid = [int(g.edge_mask.sum()) for g in batches]
    plan = [0, 1, 2, 2]
    q = min(v for v, a in zip(valid, plan) if a == 2) // 3
    return batches, plan, q, ds.num_classes


def _graphed_run(parts):
    """Two graphed learned epochs with an eval after each, then three
    ``predict`` calls (fake capture): every output and the parameters."""
    batches, plan, q, classes = parts
    cfg = Config(**BASE)
    tm = GCNIIModel(batches[0].x.shape[1], cfg.nhid, classes, cfg.drop_rate,
                    "GCN", generator=torch.Generator().manual_seed(1),
                    layers=3, width=24)
    opt = DualOptimizer.create(tm, "GCNII", cfg.lr, cfg.weight_decay)
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


def test_graphed_gcnii_is_the_same_with_stamps_on(parts, stamp_log,
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
        # each of the 3 layers' propagations: a backbone stamp before it,
        # an aggregate stamp after it
        assert seen[f"{phase}.aggregate"] > 0, phase
        assert seen[f"{phase}.aggregate"] % 3 == 0, phase
        assert seen[f"{phase}.backbone"] >= seen[f"{phase}.aggregate"]


# ------------------------------------ GCNConv on the shared normalisation

def _gcn_conv_before(conv, x, senders, receivers, edge_weight=None,
                     exchange=None, edge_mask=None):
    """``GCNConv.forward`` as it read before ``gcn_propagate``."""
    n = x.shape[0]
    dense = isinstance(senders, DenseEdges)
    cs = col_shard(conv)
    if cs is not None and edge_weight is not None:
        edge_weight = cs.copy_in(edge_weight)
    if edge_mask is not None:
        mf = edge_mask.float()
        edge_weight = mf if edge_weight is None \
            else edge_weight.float() * mf
    if dense:
        deg = senders.adj.sum(dim=1) + 1.0
    else:
        w_deg = (torch.ones(senders.shape[0], dtype=torch.float32,
                            device=x.device)
                 if edge_weight is None else edge_weight.float())
        deg = segment_sum_scalar(w_deg, receivers, n) + 1.0
    dis = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-32)), 0.0)
    xw = linear(x, conv.lin, conv.dtype)
    xs = xw * dis[:, None].to(xw.dtype)
    if exchange is not None:
        agg = spmm(senders, receivers, edge_weight, exchange(xs).float(), n)
    elif dense:
        agg = senders.adj.to(xw.dtype) @ xs
    else:
        agg = spmm(senders, receivers, edge_weight, xs, n,
                   backend=conv.backend)
    out = (agg.float() * dis[:, None]
           + (dis * dis)[:, None] * xw.float())
    return out + conv.bias


@pytest.mark.parametrize("case", ["unweighted", "weighted", "edge_mask",
                                  "exchange", "dense", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_conv_is_bit_identical_on_the_helper(case, dtype):
    n, e, f = 40, 300, 12
    x, s, r, w = _graph(n, e, f, 8)
    conv = GCNConv(f, 16, dtype, torch.Generator().manual_seed(2),
                   backend="fused" if case == "fused" else "auto")
    kw = {}
    if case in ("weighted", "edge_mask", "exchange", "dense", "fused"):
        kw["edge_weight"] = w
    if case == "edge_mask":
        kw["edge_mask"] = torch.arange(e) % 5 != 0
    if case == "exchange":
        kw["exchange"] = lambda t: t
    if case == "dense":
        s, r = dense_adj(s, r, n, w), None
        del kw["edge_weight"]
    outs = []
    for fn in (conv.forward, functools.partial(_gcn_conv_before, conv)):
        conv.zero_grad()
        xg = x.clone().requires_grad_(True)
        wg = {k: (v.clone().requires_grad_(True)
                  if k == "edge_weight" else v) for k, v in kw.items()}
        out = fn(xg, s, r, **wg)
        out.square().sum().backward()
        outs.append([out.detach(), xg.grad] + [p.grad.clone() for p in
                                               conv.parameters()]
                    + ([wg["edge_weight"].grad] if "edge_weight" in wg
                       else []))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

"""The port's halo route (``sgs_gnn_tpu_torch/parallel/halo.py`` and
``halo_train.py``) on 4 gloo ranks on the CPU, against the JAX package.

One spawn of D=4 ranks (``test_torch_parallel.run_local_ranks``, the
module fixture ``ranks``) runs every rank-side computation; the tests hold what
it returns against the JAX package in this process, from the same seeded
numpy inputs and the same flax weights (``params_from_jax``). The graph
is banded (node i links to nodes within 8 of it) and the partition
contiguous, so at D=4 the ring has three rounds, one of them empty for
every pair of ranks (round 2: ranks two apart share no edge).

Tolerances: tables exact; SpMM and forwards rtol = atol = 1e-4 (the JAX
tests'); full-mode gradients rtol 1e-3, atol 1e-6 (the JAX test's halo
against single-device bound), losses along 3 steps rtol 1e-4 and the
parameters within the lr band that test_halo.py explains.

The module imports no JAX at its top: the ranks import it by name.
"""
import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch import Config, get_model
from sgs_gnn_tpu_torch.data import (partition_nodes, sbm_graph, to_undirected,
                                    train_val_test_masks)
from sgs_gnn_tpu_torch.eval import aggregate_eval
from sgs_gnn_tpu_torch.ops import gather_rows, scatter_add
from sgs_gnn_tpu_torch.parallel import (build_halo_batch, halo_full_forward,
                                        make_halo_eval_step,
                                        make_halo_train_step)
from sgs_gnn_tpu_torch.parallel.halo import (build_halo_partition,
                                             make_halo_spmm, shard_features)
from sgs_gnn_tpu_torch.parallel.halo_train import global_masked_ce
from sgs_gnn_tpu_torch.parallel.partitioned import all_reduce_mean
from sgs_gnn_tpu_torch.train import DualOptimizer
from sgs_gnn_tpu_torch.train.pipelines import param_grads

from test_torch_parallel import run_local_ranks

D, N, F, C, HID = 4, 400, 16, 4, 32
# (label, backbone, heads): GAT with 2 heads, as test_halo.py:296, and
# with the one head the training path runs ((N,) attention tables)
FORWARD_GNNS = (("GCN", "GCN", 1), ("GIN", "GIN", 1), ("Cheb", "Cheb", 1),
                ("GAT", "GAT", 2), ("GAT1", "GAT", 1))
# the learned pipelines of test_halo.py :164 and :234-272
PIPELINES = (("hybrid", "GCN", 30), ("straight_through", "GCN", 25),
             ("two_pass", "GCN", 25), ("hybrid", "GIN", 25),
             ("hybrid", "GAT", 25))
FULL_STEPS = 3
LR = 0.01


def banded_graph(seed=0):
    """Node i links to 4 random nodes within 8 of it (undirected); the
    class changes every 10 nodes and shifts the gaussian features; the
    partition is D contiguous blocks."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(N), 4)
    dst = np.clip(src + rng.choice([-8, -5, -3, -1, 1, 2, 4, 7], src.size),
                  0, N - 1)
    keep = src != dst
    ei = to_undirected(np.stack([src[keep], dst[keep]]).astype(np.int64))
    y = ((np.arange(N) // 10) % C).astype(np.int32)
    centers = rng.normal(size=(C, F))
    x = (centers[y] + 0.7 * rng.normal(size=(N, F))).astype(np.float32)
    tm, vm, te = train_val_test_masks(N)
    part = (np.arange(N) * D // N).astype(np.int32)
    return x, ei, y, tm, vm, te, part


def sbm_fixture():
    """test_halo.py's training fixture (``_setup_halo(d=4, n=400)``): SBM,
    undirected, the reference's masks, the default partitioner."""
    x, ei, y, _ = sbm_graph(n=N, num_classes=C, deg=8, h=0.7, feat_dim=F,
                            seed=0)
    ei = to_undirected(ei)
    tm, vm, te = train_val_test_masks(N)
    return x, ei, y, tm, vm, te, partition_nodes(ei, N, D)


def _halo_cfg(**kw):
    kw.setdefault("drop_rate", 0.0)
    kw.setdefault("GNN", "GCN")
    return Config(dataset="SyntheticSBM", **kw)


def _batch(graph, rank, cfg):
    x, ei, y, tm, vm, te, part = graph
    return build_halo_batch(x, ei, y, tm, vm, te, None, D, C,
                            sample_perc=cfg.sample_perc, part=part,
                            rank=rank, device="cpu")


def _model(gnn, heads, state, dropout=0.0, scorer="MLP"):
    m = get_model(gnn, F, HID, C, dropout, scorer, heads=heads,
                  device="cpu")
    m.load_state_dict(state)
    return m


def _numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _rank_jobs(mesh, graph, weights, seeds):
    """Every rank-side computation of this file on one rank of D."""
    r = mesh.rank
    x, ei, y, tm, vm, te, part = graph
    out = {}

    # the exchange: ext rows hold the global ids the senders name; the
    # backward returns to each row the number of places it reached
    cfg = _halo_cfg()
    hb = _batch(graph, r, cfg)
    ids = np.full(hb.x.shape[0], -1.0, np.float32)
    mine = np.where(part == r)[0]
    ids[:len(mine)] = mine
    v = torch.tensor(ids, requires_grad=True)
    ext = hb.exchange(v)
    ext.sum().backward()
    out["exchange"] = dict(
        ext_senders=ext[hb.senders_ext.long()].detach().numpy(),
        edge_mask=hb.edge_mask.numpy(), grad=v.grad.numpy(),
        send_splits=list(hb.exchange.send_splits),
        recv_splits=list(hb.exchange.recv_splits))

    # SpMM: v1 (all-gather, parallel/halo.py) and v2 (the exchange + a
    # local segment sum, as GCNConv aggregates under halo)
    hp = build_halo_partition(ei, part, D)
    w = np.random.default_rng(0).uniform(0.1, 1.0, ei.shape[1]).astype(
        np.float32)
    w_loc = np.zeros(hp.senders_glob.shape[1], np.float32)
    eidx = np.where(part[ei[1]] == r)[0]
    w_loc[:len(eidx)] = w[eidx]
    xs = torch.tensor(shard_features(x, hp)[r])
    v1 = make_halo_spmm(hp, mesh)(xs, torch.tensor(w_loc))
    msgs = gather_rows(hb.exchange(hb.x), hb.senders_ext) * torch.where(
        hb.edge_mask, torch.tensor(w_loc), 0.0)[:, None]
    v2 = scatter_add(msgs, hb.receivers_loc, hb.x.shape[0])
    out["spmm"] = dict(v1=v1.numpy(), v2=v2.numpy())

    # the deterministic full-graph forward of each backbone
    out["forward"] = {
        label: halo_full_forward(_model(gnn, heads, weights[label]), hb,
                                 mesh).numpy()
        for label, gnn, heads in FORWARD_GNNS}

    # full mode: the gradients of the global loss (the D factor) and a
    # 3-step trajectory of the train step
    cfg = _halo_cfg(mode="full", nhid=HID, lr=LR)
    model = _model("GCN", 1, weights["GCN"])
    opt = DualOptimizer.create(model, "GCN", cfg.lr, cfg.weight_decay)
    logits = model(hb.x, hb.senders_ext, hb.receivers_loc, None, True, None,
                   hb.exchange, hb.edge_mask)
    loss = global_masked_ce(logits, hb.y, hb.train_mask)
    grads = param_grads(loss, opt.params)
    out["grads"] = {n: g.numpy() for n, g in
                    zip(opt.names, all_reduce_mean(grads, mesh))}
    step = make_halo_train_step(cfg, model, opt, 5, mesh)
    gen = torch.Generator()
    losses = [float(step(hb, ep, seeds["full"], gen).loss)
              for ep in range(FULL_STEPS)]
    out["full_steps"] = dict(losses=losses, params=_numpy_state(model))

    # learned pipelines train, on test_halo.py's fixture
    sbm = sbm_fixture()
    out["train"] = {}
    for pipeline, gnn, steps in PIPELINES:
        cfg = _halo_cfg(mode="learned", nhid=HID, pipeline=pipeline,
                        GNN=gnn, conditional=True, reg1=True, reg2=True,
                        sample_perc=0.5, num_samples_eval=3, drop_rate=0.1)
        hb_l = _batch(sbm, r, cfg)
        model = get_model(gnn, F, HID, C, cfg.drop_rate, cfg.edge_mlp_type,
                          device="cpu")
        model.load_state_dict(weights[f"train_{gnn}"])
        opt = DualOptimizer.create(model, gnn, cfg.lr, cfg.weight_decay)
        step = make_halo_train_step(cfg, model, opt, steps, mesh)
        ev = make_halo_eval_step(cfg, model, mesh)
        gen = torch.Generator()
        ls = [float(step(hb_l, ep, 1000 + ep, gen).loss)
              for ep in range(steps)]
        agg = aggregate_eval([ev(hb_l, 5, gen)])
        out["train"][f"{pipeline}_{gnn}"] = dict(losses=ls, eval=agg)
    return out


@pytest.fixture(scope="module")
def setup():
    """The graph, the flax weights of each backbone as port state dicts,
    and the JAX package's model for each."""
    import jax
    import jax.numpy as jnp
    from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
    from sgs_gnn_tpu_torch import params_from_jax
    graph = banded_graph()
    x, ei = graph[0], graph[1]
    models, params, weights = {}, {}, {}
    # the training models of test_halo.py :164 and :234-272 (the default
    # GCN scorer), initialised as there
    xs, eis = sbm_fixture()[:2]
    for gnn in {g for _, g, _ in PIPELINES}:
        jm = jax_get_model(gnn, F, HID, C, dropout_prob=0.1,
                           edge_mlp_type=_halo_cfg().edge_mlp_type)
        weights[f"train_{gnn}"] = params_from_jax(jax.tree_util.tree_map(
            np.asarray, init_params(jm, jax.random.PRNGKey(2),
                                    jnp.asarray(xs), jnp.asarray(eis[0]),
                                    jnp.asarray(eis[1]))))
    for label, gnn, heads in FORWARD_GNNS:
        models[label] = jax_get_model(gnn, F, HID, C, dropout_prob=0.0,
                                      heads=heads)
        params[label] = init_params(models[label], jax.random.PRNGKey(0),
                                    jnp.asarray(x), jnp.asarray(ei[0]),
                                    jnp.asarray(ei[1]))
        weights[label] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, params[label]))
    return graph, models, params, weights


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    graph, _, _, weights = setup
    torch.set_num_threads(1)
    return run_local_ranks(_rank_jobs, D, str(tmp_path_factory.mktemp(
        "ranks")), graph, weights, dict(full=9), timeout_s=600)


def _assemble(per_rank, part):
    """Global rows from each rank's (N_loc, ...) local rows."""
    out = np.zeros((N,) + per_rank[0].shape[1:], per_rank[0].dtype)
    for p in range(D):
        ids = np.where(part == p)[0]
        out[ids] = per_rank[p][:len(ids)]
    return out


def test_halo_tables_match_jax(setup):
    """Every rank's shard and ring schedule equal the JAX tables, with one
    ring round empty for every pair and more than one round."""
    from sgs_gnn_tpu.parallel import build_halo_batch as jax_build
    graph = setup[0]
    x, ei, y, tm, vm, te, part = graph
    cfg = _halo_cfg()
    jb = jax_build(x, ei, y, tm, vm, te, None, D, C,
                   sample_perc=cfg.sample_perc, part=part)
    assert len(jb.round_sizes) == D - 1 and 0 in jb.round_sizes
    assert sum(h > 0 for h in jb.round_sizes) > 1
    for r in range(D):
        tb = _batch(graph, r, cfg)
        assert tb.round_sizes == jb.round_sizes
        assert (tb.q_loc, tb.ext_rows, tb.gather_rows, tb.num_nodes) == (
            jb.q_loc, jb.ext_rows, jb.gather_rows, jb.num_nodes)
        np.testing.assert_array_equal(tb.send_idx,
                                      np.asarray(jb.send_idx[r]))
        for f in ("senders_ext", "receivers_loc", "edge_mask", "y",
                  "train_mask", "val_mask", "test_mask", "node_mask",
                  "prob", "x"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)[r]),
                                          err_msg=f)
        assert tb.valid_edges == jb.valid_edges


def test_halo_exchange_moves_fewer_rows_than_all_gather():
    """test_halo.py:219 on its own fixture (SBM, n=400, native partition,
    D=8): the ring moves fewer rows than an all-gather, the same count as
    JAX's tables."""
    from sgs_gnn_tpu.data import partition_nodes, sbm_graph
    from sgs_gnn_tpu.data.transforms import train_val_test_masks as jmasks
    from sgs_gnn_tpu.parallel import build_halo_batch as jax_build
    x, ei, y, _ = sbm_graph(n=400, num_classes=4, deg=8, h=0.7, feat_dim=16,
                            seed=0)
    ei = to_undirected(ei)
    tm, vm, te = jmasks(400)
    part = partition_nodes(ei, 400, 8)
    jb = jax_build(x, ei, y, tm, vm, te, None, 8, 4, part=part)
    for r in (0, 7):
        tb = build_halo_batch(x, ei, y, tm, vm, te, None, 8, 4, part=part,
                              rank=r, device="cpu")
        assert tb.ext_rows < tb.gather_rows
        assert tb.ext_rows == 8 * sum(tb.round_sizes) == jb.ext_rows
        assert tb.round_sizes == jb.round_sizes
        np.testing.assert_array_equal(tb.senders_ext.numpy(),
                                      np.asarray(jb.senders_ext[r]))


def test_exchange_rows_and_gradient(setup, ranks):
    """Each extended-space sender names its global sender; the all-to-all
    moves each round's rows (none in the empty round) and its backward
    returns each local row's fan-out."""
    graph = setup[0]
    _, ei, _, _, _, _, part = graph
    jb_rounds = _batch(graph, 0, _halo_cfg()).round_sizes
    for r, res in enumerate(ranks):
        ex = res["exchange"]
        eidx = np.where(part[ei[1]] == r)[0]
        m = ex["edge_mask"]
        np.testing.assert_array_equal(ex["ext_senders"][m], ei[0][eidx])
        for dst in range(D):
            want = 0 if dst == r else jb_rounds[(dst - r) % D - 1]
            assert ex["send_splits"][dst] == want
            assert ex["recv_splits"][dst] == (
                0 if dst == r else jb_rounds[(r - dst) % D - 1])
        tb = _batch(graph, r, _halo_cfg())
        fan = np.ones(tb.x.shape[0], np.float32)
        np.add.at(fan, tb.send_idx, 1.0)
        np.testing.assert_array_equal(ex["grad"], fan)


def test_halo_spmm_v1_and_v2_match_full_graph(setup, ranks):
    """test_halo.py:13: both exchanges compute the full graph's weighted
    SpMM (JAX ``spmm_xla`` of the whole graph)."""
    import jax.numpy as jnp
    from sgs_gnn_tpu.ops import spmm_xla
    x, ei, *_, part = setup[0]
    w = np.random.default_rng(0).uniform(0.1, 1.0, ei.shape[1]).astype(
        np.float32)
    want = np.asarray(spmm_xla(jnp.asarray(ei[0]), jnp.asarray(ei[1]),
                               jnp.asarray(w), jnp.asarray(x), N))
    for v in ("v1", "v2"):
        got = _assemble([res["spmm"][v] for res in ranks], part)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=v)


@pytest.mark.parametrize("label,gnn,heads", FORWARD_GNNS)
def test_halo_forward_matches_model_apply(setup, ranks, label, gnn, heads):
    """test_halo.py:69, :198, :275, :296: the halo forward of GCN, GIN,
    Cheb and GAT (2 heads, and 1) equals the JAX model's full-graph forward, and
    JAX's own halo forward on a 4-device mesh."""
    import jax.numpy as jnp
    from sgs_gnn_tpu.core import Config as JConfig
    from sgs_gnn_tpu.parallel import build_halo_batch as jax_build
    from sgs_gnn_tpu.parallel import make_mesh
    from sgs_gnn_tpu.parallel.halo_train import (
        halo_full_forward as jax_halo_forward)
    graph, models, params, _ = setup
    x, ei, y, tm, vm, te, part = graph
    want = np.asarray(models[label].apply(
        params[label], jnp.asarray(x), jnp.asarray(ei[0]),
        jnp.asarray(ei[1]), None, deterministic=True))
    got = _assemble([res["forward"][label] for res in ranks], part)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    cfg = _halo_cfg()
    jcfg = JConfig(mode="full", dataset="SyntheticSBM", GNN=gnn, nhid=HID,
                   drop_rate=0.0)
    jb = jax_build(x, ei, y, tm, vm, te, None, D, C,
                   sample_perc=cfg.sample_perc, part=part)
    jax_sh = np.asarray(jax_halo_forward(jcfg, params[label], jb,
                                         make_mesh(D)))
    np.testing.assert_allclose(got, _assemble(list(jax_sh), part),
                               rtol=1e-4, atol=1e-4)


def test_halo_full_mode_training_matches_single_device(setup, ranks):
    """test_halo.py:92: the gradients of the global loss, averaged over
    the ranks, equal the JAX single-device full-graph gradients (each
    rank's carry the factor D that the mean removes); 3 full-mode halo
    steps follow JAX's single-device full-mode steps."""
    import jax
    import jax.numpy as jnp
    from sgs_gnn_tpu.core import Config as JConfig, Graph as JGraph
    from sgs_gnn_tpu.train import DualOptimizer as JOpt
    from sgs_gnn_tpu.train import make_train_step as jax_make_train_step
    from sgs_gnn_tpu.train.losses import masked_cross_entropy
    from sgs_gnn_tpu_torch import params_from_jax
    graph, models, params, _ = setup
    x, ei, y, tm, vm, te, part = graph
    model, p0 = models["GCN"], params["GCN"]
    g = JGraph.build(x, ei, y, tm, vm, te, num_classes=C)

    def single_loss(p):
        out = model.apply(p, g.x, g.senders, g.receivers, None,
                          deterministic=True)
        return masked_cross_entropy(out, g.y, g.train_mask)

    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(single_loss)(p0)))
    for res in ranks:
        for name, gr in res["grads"].items():
            np.testing.assert_allclose(gr, want[name].numpy(), rtol=1e-3,
                                       atol=1e-6, err_msg=name)
    jcfg = JConfig(mode="full", dataset="SyntheticSBM", nhid=HID, lr=LR,
                   drop_rate=0.0, donate=False)
    opt = JOpt.create(p0, "GCN", jcfg.lr, jcfg.weight_decay)
    step = jax_make_train_step(jcfg, model, opt, q=ei.shape[1] + 1,
                               max_epoch=5)
    p, s = p0, opt.init(p0)
    losses = []
    with jax.disable_jit():
        for ep in range(FULL_STEPS):
            p, s, m = step(p, s, g, jnp.asarray(ep), jax.random.PRNGKey(9))
            losses.append(float(m.loss))
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    for res in ranks:
        np.testing.assert_allclose(res["full_steps"]["losses"], losses,
                                   rtol=1e-4)
        for name, val in res["full_steps"]["params"].items():
            np.testing.assert_allclose(val, want_p[name].numpy(),
                                       atol=FULL_STEPS * 2 * LR, rtol=1e-3,
                                       err_msg=name)


@pytest.mark.parametrize("pipeline,gnn,steps", PIPELINES)
def test_halo_pipelines_train(ranks, pipeline, gnn, steps):
    """test_halo.py:164 and :234-272: every learned pipeline (and the GIN
    and GAT backbones) trains under halo: the loss falls, train F1 > 0.5,
    and every rank saw the same (global) losses."""
    key = f"{pipeline}_{gnn}"
    losses = ranks[0]["train"][key]["losses"]
    assert len(losses) == steps and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    for res in ranks[1:]:
        np.testing.assert_allclose(res["train"][key]["losses"], losses,
                                   rtol=1e-6)
        assert res["train"][key]["eval"] == ranks[0]["train"][key]["eval"]
    assert ranks[0]["train"][key]["eval"]["train_f1"] > 0.5

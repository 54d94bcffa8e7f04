"""Hidden-dimension tensor parallelism of the port
(``sgs_gnn_tpu_torch/parallel/tensor_parallel.py``,
``mesh.make_dp_tp_mesh``) on gloo ranks on the CPU: the twins of
``tests/test_parallel.py``'s TP tests (:220, :274, :315).

Two spawns (module fixtures, ``run_local_ranks`` of
``tests/test_torch_parallel.py``): W=2 ranks run the tp = 2 jobs (and the
dp = 2 x tp = 1 super-steps that the dp x tp run is held to), W=4 ranks
the dp = 2 x tp = 2 super-steps and the nhid 256 step at tp = 4. The tests
hold what the ranks return against the unsharded port in this process and
against JAX's ``shard_params_tp`` on its virtual 8-device mesh
(``tests/conftest.py``), from the same seeded numpy inputs and weights.

Dropout is 0 wherever an unsharded run is compared (as JAX's test has it,
test_parallel.py:235): the unsharded head is fused and draws its mask by
``hash32``, the sharded one is unfused and draws from the generator. The
sliced dropout masks of the sharded encoders are held on their own. Limits:
JAX's (loss rtol 2e-4, parameters rtol 2e-3 and atol 2e-5); forwards
rtol = atol = 1e-5 (outputs of magnitude up to ~5 whose row layers sum
their partial products per rank: f32 sums in another order).

The module imports no JAX at its top: the ranks import it by name.
"""
import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch import (Config, DualOptimizer, Graph, get_model,
                               make_eval_step, make_train_step)
from sgs_gnn_tpu_torch.eval import aggregate_eval
from sgs_gnn_tpu_torch.models import scorers
from sgs_gnn_tpu_torch.parallel import (gather_params_tp, is_sharded,
                                        make_dp_tp_mesh, make_mesh,
                                        make_parallel_eval_step,
                                        make_parallel_train_step,
                                        shard_params_tp, tp_param_spec)
from sgs_gnn_tpu_torch.train import make_scan_epoch_step, pipelines

from test_torch_parallel import (frozen_sample_edges, partitions,
                                 run_local_ranks)

N, E, F_IN, C = 50, 400, 16, 4          # conftest.random_graph's sizes
Q = E // 3                              # test_parallel.py:241
STEPS = 3
LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
HYBRID = dict(mode="learned", pipeline="hybrid", GNN="GCN",
              edge_mlp_type="GCN", conditional=True, reg1=True, reg2=True,
              nhid=32, drop_rate=0.0)
# one pair per backbone, the MLP and GSAGE scorers each at least twice
JAX_PAIRS = (("GCN", "MLP"), ("GIN", "GSAGE"), ("GAT", "MLP"),
             ("Cheb", "GSAGE"))
JAX_NHID = 16
DROP = 0.3
DP_NHID = 16


def graph_arrays(seed=0):
    """``tests/conftest.py`` ``random_graph``'s arrays from
    ``default_rng(seed)`` (the ``small_graph`` fixture at seed 0)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, size=E).astype(np.int32)
    r = rng.integers(0, N, size=E).astype(np.int32)
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    y = rng.integers(0, C, size=N).astype(np.int32)
    perm = rng.permutation(N)
    tr = np.zeros(N, bool)
    tr[perm[:N // 3]] = True
    va = np.zeros(N, bool)
    va[perm[N // 3:2 * N // 3]] = True
    te = np.zeros(N, bool)
    te[perm[2 * N // 3:]] = True
    prob = rng.uniform(0.1, 1.0, size=E).astype(np.float32)
    prob = prob / prob.sum()
    return x, np.stack([s, r]), y, tr, va, te, prob


def port_graph():
    x, ei, y, tr, va, te, prob = graph_arrays()
    return Graph.build(x, ei, y, tr, va, te, prob=prob, num_classes=C,
                       device="cpu")


def _model(gnn, scorer, nhid, state=None, seed=0, dropout=0.0, in_ch=F_IN,
            classes=C):
    m = get_model(gnn, in_ch, nhid, classes, dropout, scorer, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    if state is not None:
        m.load_state_dict(state)
    return m


def _numpy(state):
    return {k: v.detach().numpy().copy() for k, v in state.items()}


def train(cfg, model, g, steps=STEPS, q=Q):
    """``steps`` steps of ``make_train_step`` (the optimizer built on the
    model as it is: after ``shard_params_tp`` when sharded); the losses
    and gates."""
    opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
    step = make_train_step(cfg, model, opt, q, max_epoch=5)
    out = []
    for ep in range(steps):
        m = step(g, ep, torch.Generator().manual_seed(100 + ep))
        out.append((float(m.loss), float(m.conditional_update)))
    return out


def evaluate(cfg, model, g):
    return aggregate_eval([make_eval_step(cfg, model, Q)(
        g, torch.Generator().manual_seed(7))])


def dp_cfg():
    return Config(**dict(HYBRID, nhid=DP_NHID))


def dp_steps(mesh, model, graphs, steps=STEPS):
    """``steps`` super-steps on this rank's partition (its data rank's);
    the losses, gates and eval F1s."""
    cfg = dp_cfg()
    g = graphs[mesh.data_rank]
    q = max(int(min(int(x.edge_mask.sum()) for x in graphs) * 0.5), 8)
    opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
    step = make_parallel_train_step(cfg, model, opt, q, 5, mesh)
    gen = torch.Generator()
    out = [(float(m.loss), float(m.conditional_update))
           for m in (step(g, ep, 11 + ep, gen) for ep in range(steps))]
    ev = make_parallel_eval_step(cfg, model, q, mesh)(g, 3, gen)
    return out, aggregate_eval([ev])


def encoders(model, g, seed):
    """The backbone's forward and the scorer's encoder in training mode
    (dropout on), each from a generator seeded ``seed``."""
    out = model(g.x, g.senders, g.receivers, None, deterministic=False,
                generator=torch.Generator().manual_seed(seed))
    enc = model.encode_scorer(g.x, g.senders, g.receivers,
                              deterministic=False,
                              generator=torch.Generator().manual_seed(seed))
    return out.detach().numpy(), enc.detach().float().numpy()


def frozen_jax_step(cfg, model, g, idx, rand_idx):
    """One step with ``pipelines``' samplers frozen (the test_torch_train
    way); the loss."""
    saved = pipelines.sample_edges, pipelines.sample_prior_edges
    pipelines.sample_edges = frozen_sample_edges(idx)
    pipelines.sample_prior_edges = \
        lambda *a, **k: torch.as_tensor(rand_idx)
    try:
        return train(cfg, model, g, steps=1)[0][0]
    finally:
        pipelines.sample_edges, pipelines.sample_prior_edges = saved


# --------------------------------------------------------- the ranks' jobs


def _jobs2(mesh, states, idx, rand_idx):
    """Every W=2 job on one rank."""
    torch.set_num_threads(1)
    out = {}
    g = port_graph()
    tp2 = make_dp_tp_mesh(1, 2)
    out["mesh"] = (tp2.dp, tp2.tp, tp2.data_rank, tp2.model_rank,
                   tp2.world, tp2.rank, tp2.backend)
    try:
        make_dp_tp_mesh(2, 2)
    except ValueError as e:
        out["mesh_error"] = str(e)

    # TP equals unsharded (test_parallel.py:220)
    cfg = Config(**HYBRID)
    model = shard_params_tp(_model("GCN", "GCN", 32, states["hybrid"]), tp2)
    out["sharded"] = is_sharded(model)
    out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["hybrid"] = dict(steps=train(cfg, model, g),
                         params=_numpy(gather_params_tp(model, tp2)),
                         eval=evaluate(cfg, model, g))
    # the graphed epoch and the tile scorer refuse a sharded model
    opt = DualOptimizer.create(model, "GCN", 1e-3, 0.0)
    for name, call in (
            ("graphed", lambda: make_scan_epoch_step(cfg, model, opt, Q, 5,
                                                     1)),
            ("tiles", lambda: model.score_tiles_from_embeddings(
                torch.zeros(N, 32), *([torch.zeros(1, dtype=torch.int32)]
                                      * 4), 16, 32))):
        try:
            call()
        except ValueError as e:
            out[f"{name}_error"] = str(e)

    # the sliced dropout masks of the sharded encoders
    out["dropout"] = {}
    for gnn, scorer in (("GCN", "GCN"), ("GIN", "MLP"), ("Cheb", "GSAGE")):
        m = _model(gnn, scorer, 32, states[f"drop {gnn}"], dropout=DROP)
        out["dropout"][gnn] = encoders(shard_params_tp(m, tp2), g, 5)

    # TP against JAX: one frozen step per backbone
    out["jax"] = {}
    for gnn, scorer in JAX_PAIRS:
        cfg = Config(**dict(HYBRID, GNN=gnn, edge_mlp_type=scorer,
                            nhid=JAX_NHID))
        m = shard_params_tp(_model(gnn, scorer, JAX_NHID,
                                   states[f"jax {gnn}"]), tp2)
        loss = frozen_jax_step(cfg, m, g, idx, rand_idx)
        out["jax"][gnn] = dict(loss=loss,
                               params=_numpy(gather_params_tp(m, tp2)))

    # nhid not divisible by tp
    m = _model("GCN", "GCN", 15)
    before = _numpy(m.state_dict())
    try:
        shard_params_tp(m, tp2)
    except ValueError as e:
        out["divisible"] = dict(error=str(e), unchanged=all(
            np.array_equal(before[k], v)
            for k, v in _numpy(m.state_dict()).items()),
            sharded=is_sharded(m))

    # the data-parallel super-steps at dp = 2, tp = 1: the dp x tp run's
    # reference
    graphs = partitions(2)
    m = _model("GCN", "GCN", DP_NHID, states["dp"], in_ch=64)
    dp_mesh = make_mesh(2, "cpu")
    out["dp"] = dp_steps(dp_mesh, m, graphs) + (_numpy(m.state_dict()),)
    return out


def _jobs4(mesh, states):
    """Every W=4 job on one rank."""
    torch.set_num_threads(1)
    out = {}
    # dp = 2 x tp = 2: partition data_rank, the hidden width split in two
    dptp = make_dp_tp_mesh(2, 2)
    out["mesh"] = (dptp.data_rank, dptp.model_rank)
    m = shard_params_tp(_model("GCN", "GCN", DP_NHID, states["dp"],
                               in_ch=64), dptp)
    out["dp_tp"] = dp_steps(dptp, m, partitions(2)) + (
        _numpy(gather_params_tp(m, dptp)),)

    # nhid 256 at tp = 4 (test_parallel.py:274): the fused head is never
    # called on the sharded head
    tp4 = make_dp_tp_mesh(1, 4)
    fused = scorers.score_head_sampled

    def refuse(*a, **k):
        raise AssertionError("the fused head ran on a sharded head")

    scorers.score_head_sampled = refuse
    try:
        m = shard_params_tp(_model("GCN", "GCN", 256, states["wide"]), tp4)
        cfg = Config(**dict(HYBRID, conditional=False, reg1=False,
                            reg2=False, nhid=256))
        out["wide"] = dict(steps=train(cfg, m, port_graph(), steps=1),
                           fc1=tuple(m.edge_prob_mlp.head.fc1.weight.shape))
    finally:
        scorers.score_head_sampled = fused
    return out


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def setup():
    """The weights of every job (flax's, moved by ``params_from_jax``, for
    the JAX comparisons; the port's initialisers otherwise) and the frozen
    sample."""
    import jax
    from sgs_gnn_tpu.core import Graph as JGraph
    from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
    from sgs_gnn_tpu_torch import params_from_jax
    x, ei, y, tr, va, te, prob = graph_arrays()
    jg = JGraph.build(x, ei, y, tr, va, te, prob=prob, num_classes=C)
    states = {"hybrid": _model("GCN", "GCN", 32, seed=1).state_dict(),
              "dp": _model("GCN", "GCN", DP_NHID, seed=2,
                           in_ch=64).state_dict(),
              "wide": _model("GCN", "GCN", 256, seed=3).state_dict()}
    for gnn, scorer in (("GCN", "GCN"), ("GIN", "MLP"), ("Cheb", "GSAGE")):
        states[f"drop {gnn}"] = _model(gnn, scorer, 32, seed=4,
                                       dropout=DROP).state_dict()
    params = {}
    for gnn, scorer in JAX_PAIRS:
        jm = jax_get_model(gnn, F_IN, JAX_NHID, C, 0.0, scorer)
        params[gnn] = init_params(jm, jax.random.PRNGKey(0), jg.x,
                                  jg.senders, jg.receivers)
        states[f"jax {gnn}"] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, params[gnn]))
    rng = np.random.default_rng(3)
    idx = np.sort(rng.choice(E, Q, replace=False)).astype(np.int32)
    rand_idx = rng.choice(E, Q, replace=False).astype(np.int32)
    return dict(states=states, params=params, jg=jg, idx=idx,
                rand_idx=rand_idx)


@pytest.fixture(scope="module")
def ranks2(setup, tmp_path_factory):
    return run_local_ranks(_jobs2, 2, str(tmp_path_factory.mktemp("tp2")),
                           setup["states"], setup["idx"], setup["rand_idx"],
                           timeout_s=600)


@pytest.fixture(scope="module")
def ranks4(setup, tmp_path_factory):
    return run_local_ranks(_jobs4, 4, str(tmp_path_factory.mktemp("tp4")),
                           setup["states"], timeout_s=600)


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


def _close_params(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k,
                                   **PARAM_TOL)


def _close_steps(got, want):
    assert [g for _, g in got] == [g for _, g in want], (got, want)
    np.testing.assert_allclose([v for v, _ in got], [v for v, _ in want],
                               rtol=LOSS_RTOL)


# -------------------------------------------------------------------- tests


GNNS = ("GCN", "GIN", "GAT", "Cheb")
SCORERS = ("MLP", "GSAGE", "GCN")


@pytest.mark.parametrize("gnn,scorer", [(g, s) for g in GNNS
                                        for s in SCORERS])
def test_tp_param_specs_match_jax(gnn, scorer):
    """test_parallel.py:315's twin: every parameter of each backbone x
    scorer pair gets JAX's spec, mapped through ``params_from_jax``
    (P(None, "model") of a kernel is dim 0 of the weight, P("model", None)
    dim 1, P("model") of a bias dim 0, P() whole)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
    from sgs_gnn_tpu.parallel import tp_param_spec as jax_spec
    jm = jax_get_model(gnn, 12, 16, 3, 0.0, scorer)
    p = init_params(jm, jax.random.PRNGKey(0), jnp.ones((8, 12)),
                    jnp.zeros(10, jnp.int32), jnp.zeros(10, jnp.int32))
    want = {}

    def record(path, leaf):
        keys = [k.key for k in path if hasattr(k, "key")][1:]
        kernel = keys[-1] == "kernel"
        name = ".".join(keys[:-1] + ["weight" if kernel else keys[-1]])
        spec = jax_spec(path, leaf)
        # a kernel (in, out) is the transposed weight (out, in)
        want[name] = {P(None, "model"): 0, P("model", None): 1,
                      P("model"): 0, P(): None}[spec]

    jax.tree_util.tree_map_with_path(record, p)
    model = get_model(gnn, 12, 16, 3, 0.0, scorer, device="cpu")
    got = {n: tp_param_spec(n, t) for n, t in model.named_parameters()}
    assert got == want
    assert any(v is not None for v in got.values())


def test_dp_tp_mesh_layout(ranks2, ranks4):
    """Rank r of dp x tp sits at (r // tp, r % tp), as JAX's
    ``devices.reshape(dp, tp)``; a dp x tp that is not the world size
    raises, as JAX's assert does."""
    for r, res in enumerate(ranks2):
        assert res["mesh"] == (1, 2, 0, r, 2, r, "gloo")
        assert "not the world size 2" in res["mesh_error"]
    assert [res["mesh"] for res in ranks4] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]


def test_tp_training_matches_unsharded(ranks2):
    """test_parallel.py:220's twin: ``make_train_step`` on a model sharded
    at tp = 2 (GCN + GCN, conditional, reg1 and reg2, dropout 0) follows
    the unsharded step: the same losses and gates over 3 steps, the same
    parameters after them; both ranks the same. The sharded shapes are
    JAX's: gcn1 split on its output units, gcn2 on its input units."""
    g = port_graph()
    cfg = Config(**HYBRID)
    model = _model("GCN", "GCN", 32, seed=1)
    want = train(cfg, model, g)
    for res in ranks2:
        assert res["sharded"]
        _close_steps(res["hybrid"]["steps"], want)
        _close_params(res["hybrid"]["params"], model.state_dict())
    shapes = ranks2[0]["shapes"]
    assert shapes["gcn1.lin.weight"] == (16, F_IN)
    assert shapes["gcn2.lin.weight"] == (C, 16)
    assert shapes["gcn1.bias"] == (16,) and shapes["gcn2.bias"] == (C,)
    assert shapes["edge_prob_mlp.head.fc1.weight"] == (16, 64)
    assert shapes["edge_prob_mlp.head.fc2.weight"] == (1, 16)
    assert shapes["edge_prob_mlp.head.fc2.bias"] == (1,)


def test_tp_eval_matches_unsharded(ranks2):
    """The learned-mode eval of the sharded model (its head unfused) gives
    the unsharded model's F1s."""
    g = port_graph()
    cfg = Config(**HYBRID)
    model = _model("GCN", "GCN", 32, seed=1)
    train(cfg, model, g)
    want = evaluate(cfg, model, g)
    for res in ranks2:
        assert res["hybrid"]["eval"] == pytest.approx(want, abs=1e-9)


def test_dp_tp_super_steps_match_dp(ranks2, ranks4):
    """dp = 2 x tp = 2 (4 ranks, two partitions) against the one-axis
    data-parallel super-steps (``make_mesh``, dp = 2, tp = 1): the same
    losses, gates and eval F1s, the same parameters; every rank of dp x
    tp the same."""
    steps, ev, params = ranks2[0]["dp"]
    for res in ranks4:
        got_steps, got_ev, got_params = res["dp_tp"]
        _close_steps(got_steps, steps)
        assert got_ev == pytest.approx(ev, abs=1e-9)
        _close_params(got_params, params)


@pytest.mark.parametrize("gnn", ["GCN", "GIN", "Cheb"])
def test_sliced_dropout_masks(ranks2, gnn):
    """The backbone's forward (gcn1, dropout 0.3, gcn2; GIN's; Cheb's) and
    the scorer's encoder (GCN: gcn1, dropout, gcn2; MLP and GSAGE: a column
    layer, dropout, the all-gather) in training mode at tp = 2 equal the
    unsharded ones from the same generator: each rank's mask is its block
    of the whole activation's mask."""
    scorer = {"GCN": "GCN", "GIN": "MLP", "Cheb": "GSAGE"}[gnn]
    model = _model(gnn, scorer, 32, seed=4, dropout=DROP)
    want = encoders(model, port_graph(), 5)
    for res in ranks2:
        for got, exp in zip(res["dropout"][gnn], want):
            np.testing.assert_allclose(got, exp, **FWD_TOL)


@pytest.mark.parametrize("gnn,scorer", JAX_PAIRS)
def test_tp_step_matches_jax_tp(monkeypatch, setup, ranks2, gnn, scorer):
    """JAX's ``shard_params_tp`` on ``make_dp_tp_mesh(1, 2)`` against the
    port at tp = 2: one step of each backbone (the MLP and GSAGE scorers'
    all-gather included) from the same flax weights, dropout 0, sampling
    frozen in both packages; the loss and the parameters after it."""
    import jax
    import jax.numpy as jnp
    from sgs_gnn_tpu.core import Config as JConfig
    from sgs_gnn_tpu.core.fastpath import set_pallas_enabled
    from sgs_gnn_tpu.models import get_model as jax_get_model
    from sgs_gnn_tpu.parallel import make_dp_tp_mesh as jax_mesh
    from sgs_gnn_tpu.parallel import shard_params_tp as jax_shard
    from sgs_gnn_tpu.train import DualOptimizer as JOpt
    from sgs_gnn_tpu.train.pipelines import make_train_step as jax_step
    from sgs_gnn_tpu_torch import params_from_jax
    from test_torch_train import _freeze
    _freeze(monkeypatch, setup["idx"], setup["rand_idx"])
    jcfg = JConfig(**dict(HYBRID, GNN=gnn, edge_mlp_type=scorer,
                          nhid=JAX_NHID, donate=False))
    jm = jax_get_model(gnn, F_IN, JAX_NHID, C, 0.0, scorer)
    params = setup["params"][gnn]
    opt = JOpt.create(params, gnn, jcfg.lr, jcfg.weight_decay)
    step = jax_step(jcfg, jm, opt, Q, max_epoch=5)
    try:
        p_tp = jax_shard(params, jax_mesh(1, 2))
        p_tp, _, m = step(p_tp, opt.init(p_tp), setup["jg"], jnp.asarray(0),
                          jax.random.PRNGKey(3))
        want_loss = float(m.loss)
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, p_tp))
    finally:
        set_pallas_enabled(True)
    for res in ranks2:
        got = res["jax"][gnn]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
        _close_params(got["params"], {k: v.numpy() for k, v in want.items()})


def test_tp_wide_hidden_256(ranks4):
    """test_parallel.py:274's twin: nhid 256 at tp = 4 (fc1 split to 64
    units a rank) matches the unsharded loss, and the fused head (K3 on
    the card) is never called on the sharded head."""
    cfg = Config(**dict(HYBRID, conditional=False, reg1=False, reg2=False,
                        nhid=256))
    want = train(cfg, _model("GCN", "GCN", 256, seed=3), port_graph(),
                 steps=1)
    for res in ranks4:
        assert res["wide"]["fc1"] == (64, 512)
        _close_steps(res["wide"]["steps"], want)


def test_tp_divisibility_raises(ranks2):
    """nhid 15 at tp = 2 raises ``ValueError`` with JAX's message and
    leaves the model whole and unmarked."""
    for res in ranks2:
        d = res["divisible"]
        assert "not divisible by tp=2" in d["error"], d["error"]
        assert "dim 0 size 15" in d["error"]
        assert d["unchanged"] and not d["sharded"]


def test_sharded_model_refuses_fused_routes(ranks2):
    """A sharded head refuses the tile scorer (K6's route: build the graph
    without a tile index), and the graphed epoch refuses a sharded
    model (it trains step by step)."""
    for res in ranks2:
        assert "tensor-parallel" in res["tiles_error"]
        assert "without a tile index" in res["tiles_error"]
        assert "step by step" in res["graphed_error"]

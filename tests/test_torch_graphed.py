"""The graphed epoch's parts that run without a card, on the CPU.

  * ``DualOptimizer`` now updates its state in place: the same parameters
    and moments, bit for bit, as the rebinding update it replaced (kept
    here as ``_rebinding_update``), the same as JAX's ``DualOptimizer``
    (rtol 1e-5, as tests/test_torch_train.py), the same tensors after every
    step and after ``load_state_dict``; the step's temperature is the
    schedule's host value.
  * The capture tally (``core/graphed.py``) with a fake graph: a capture
    leaves the launch counters as they were and keeps what its wrappers
    counted; every replay adds it back; a capture that raises leaves the
    counters too.
  * The graphed epoch's and eval's control flow (order, per-batch reseeds,
    skip / small / sampled cases, first batch eager then replays, the
    class buffers, device sums) with a fake capture whose replay reruns the
    captured body: equal, bit for bit, to the per-batch loop on the CPU.
  * The port's ``run_experiment`` with ``scan_epoch='auto'`` runs the loop
    on the CPU and follows JAX's ``run_experiment`` with
    ``scan_epoch='auto'`` (its ``lax.scan``) epoch by epoch in full mode
    on 4 partitions in 2 shape classes: losses rtol 1e-4, F1s within 2
    nodes of each split (the tolerances of tests/test_torch_driver.py).
"""
import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.core import Config as JConfig
from sgs_gnn_tpu.data import registry as jreg
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.run import driver as jdriver
from sgs_gnn_tpu.train.optim import DualOptimizer as JDualOptimizer

from sgs_gnn_tpu_torch import get_model, make_train_step, params_from_jax
from sgs_gnn_tpu_torch.core import Config
from sgs_gnn_tpu_torch.core import graphed
from sgs_gnn_tpu_torch.data import registry as treg
from sgs_gnn_tpu_torch.eval import (accumulate_eval_device, make_eval_step,
                                    make_scan_eval_step)
from sgs_gnn_tpu_torch.ops import _build
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.sparsify.sampling import temperature_at
from sgs_gnn_tpu_torch.train import DualOptimizer, make_scan_epoch_step

F_IN, HID, C, N = 8, 16, 4, 40
BASE = dict(dataset="SyntheticSBM", metis_threshold=20000, shape_classes=2,
            nhid=16, runs=1, num_samples_eval=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps parallel test workers from
    waiting at thread barriers. The default dtype is the port's float32
    (tests/test_reference_oracle.py sets float64 when it is imported)."""
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------------------------------------------------- optimizer


def _rebinding_update(opt, params, state, grp, grads, gate=None,
                      weight_decay=0.0):
    """The update ``DualOptimizer._group_update`` made before it wrote its
    state in place (new tensors for the count and the moments), of
    ``params`` with ``opt``'s masks and constants."""
    mask = opt.masks[grp]
    if grp not in state:
        state[grp] = [torch.zeros((), dtype=torch.int32),
                      [torch.zeros_like(p) if m else None
                       for p, m in zip(params, mask)],
                      [torch.zeros_like(p) if m else None
                       for p, m in zip(params, mask)]]
    st = state[grp]
    do_f = None if gate is None else gate.to(torch.float32)
    st[0] = st[0] + (1 if gate is None else gate.to(torch.int32))
    t = torch.clamp(st[0], min=1).to(torch.float32)
    bc1, bc2 = 1.0 - torch.pow(opt.b1, t), 1.0 - torch.pow(opt.b2, t)
    updates = []
    for i, (g, p) in enumerate(zip(grads, params)):
        m, v = st[1][i], st[2][i]
        if m is None:
            updates.append(None)
            continue
        if weight_decay:
            g = g + weight_decay * p
        m_new = opt.b1 * m + (1.0 - opt.b1) * g
        v_new = opt.b2 * v + (1.0 - opt.b2) * (g * g)
        if do_f is not None:
            m_new = do_f * m_new + (1.0 - do_f) * m
            v_new = do_f * v_new + (1.0 - do_f) * v
        upd = -opt.lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + opt.eps)
        st[1][i], st[2][i] = m_new, v_new
        updates.append(upd if do_f is None else do_f * upd)
    return updates


def _rebinding_step(opt, params, state, method, grads, gate):
    with torch.no_grad():
        if method == "step_learned":
            ups = [_rebinding_update(opt, params, state, "edge", grads, gate),
                   _rebinding_update(opt, params, state, "gnn", grads)]
        elif method == "step_gnn_only":
            ups = [_rebinding_update(opt, params, state, "gnn", grads)]
        else:
            ups = [_rebinding_update(opt, params, state, "all", grads,
                                     weight_decay=opt.weight_decay)]
        for i, p in enumerate(params):
            for u in ups:
                if u[i] is not None:
                    p.add_(u[i])


def _state_ptrs(opt):
    return {grp: [t.data_ptr() for t in [st.count] + st.mu + st.nu
                  if t is not None] for grp, st in opt.state.items()}


@pytest.mark.parametrize("method,gates", [
    ("step_learned", [True, False, True, False]),
    ("step_gnn_only", [None] * 3), ("step_all", [None] * 3)])
def test_in_place_optimizer_matches_rebinding_update_and_jax(method, gates):
    rng = np.random.default_rng(5)
    jm = jax_get_model("GCN", F_IN, HID, C, 0.0, "GCN")
    x = jnp.asarray(rng.normal(size=(N, F_IN)).astype(np.float32))
    s = jnp.asarray(rng.integers(0, N, 300).astype(np.int32))
    params = init_params(jm, jax.random.PRNGKey(0), x, s, s)
    jopt = JDualOptimizer.create(params, "GCN", 0.01, 5e-4)
    jstate, jp = jopt.init(params), params
    tm = get_model("GCN", F_IN, HID, C, 0.0, "GCN", device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    topt = DualOptimizer.create(tm, "GCN", 0.01, 5e-4)
    ref = [p.detach().clone() for p in topt.params]
    ref_state = {}
    ptrs = None
    for gate in gates:
        gr = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape)
                                  .astype(np.float32) * 1e-2), params)
        tg = params_from_jax(_np_tree(gr))
        grads = [tg[name] for name in topt.names]
        gate_t = None if gate is None else torch.tensor(gate)
        if gate is None:
            jp, jstate = getattr(jopt, method)(jp, gr, jstate)
            getattr(topt, method)(grads)
        else:
            jp, jstate = jopt.step_learned(jp, gr, jstate, jnp.asarray(gate))
            topt.step_learned(grads, gate_t)
        _rebinding_step(topt, ref, ref_state, method, grads, gate_t)
        for name, p, r in zip(topt.names, topt.params, ref):
            assert torch.equal(p.detach(), r), name
        for grp, (count, mu, nu) in ref_state.items():
            st = topt.state[grp]
            assert torch.equal(st.count, count), grp
            for a, b in zip(st.mu + st.nu, mu + nu):
                assert (a is None and b is None) or torch.equal(a, b), grp
        want = params_from_jax(_np_tree(jp))
        for name, p in zip(topt.names, topt.params):
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        # the state is written where it lies: a graph keeps reading it
        now = _state_ptrs(topt)
        if ptrs is not None:
            assert now == ptrs
        ptrs = now
    for grp in ("gnn", "edge", "all"):
        count = topt.state[grp].count if grp in topt.state else 0
        assert int(count) == int(getattr(jstate, grp).count)


def test_load_state_dict_copies_into_the_existing_state():
    tm = get_model("GCN", F_IN, HID, C, 0.0, "GCN", device="cpu")
    opt = DualOptimizer.create(tm, "GCN", 0.01, 5e-4)
    grads = [torch.full_like(p, 0.5) for p in opt.params]
    opt.step_learned(grads, torch.tensor(True))
    saved = {grp: {"count": st["count"].clone(),
                   "mu": [None if t is None else t.clone() for t in st["mu"]],
                   "nu": [None if t is None else t.clone() for t in st["nu"]]}
             for grp, st in opt.state_dict().items()}
    ptrs = _state_ptrs(opt)
    opt.step_learned(grads, torch.tensor(True))
    opt.step_all(grads)                         # a group the save lacks
    opt.load_state_dict(saved)
    assert {g: p for g, p in _state_ptrs(opt).items() if g in ptrs} == ptrs
    for grp, st in saved.items():
        assert torch.equal(opt.state[grp].count, st["count"])
        for a, b in zip(opt.state[grp].mu + opt.state[grp].nu,
                        st["mu"] + st["nu"]):
            assert (a is None and b is None) or torch.equal(a, b)
    assert int(opt.state["all"].count) == 0     # restarts as never stepped
    assert all(float(t.abs().sum()) == 0.0
               for t in opt.state["all"].mu + opt.state["all"].nu)


def test_step_temperature_follows_the_schedule():
    cfg = Config(mode="full", nhid=HID, drop_rate=0.0)
    ds = treg.get_dataset(Config(dataset="Karate"))
    g = driver.prepare_batches(cfg.replace(dataset="Karate"), ds, "cpu")[0][0]
    tm = get_model("GCN", g.x.shape[1], HID, ds.num_classes, 0.0, "GCN",
                   device="cpu")
    opt = DualOptimizer.create(tm, "GCN", cfg.lr, cfg.weight_decay)
    step = make_train_step(cfg, tm, opt, 10, max_epoch=7)
    for ep in (0, 3, 9):
        m = step(g, ep, torch.Generator().manual_seed(ep))
        assert isinstance(m.temperature, float)
        assert m.temperature == pytest.approx(
            temperature_at(ep, 7, cfg.t_init, cfg.t_min))


# ------------------------------------------------------- capture tallies


class _FakeGraph:
    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


def _no_capture(graph, pool):
    return contextlib.nullcontext()


def _counters():
    return collections.Counter(_build.LAUNCHES), \
        collections.Counter(_build.ROUTES)


def _fake_launches():
    """What a step's wrappers count: two K1 launches on one route, one K3."""
    _build.LAUNCHES["scatter_add"] += 2
    _build.ROUTES["scatter_add", "slab"] += 2
    _build.LAUNCHES["score_head_sampled"] += 1
    return "out"


def test_capture_moves_the_launches_into_the_tally():
    gen = torch.Generator()
    launches0, routes0 = _counters()
    cap = graphed.capture(_fake_launches, pool="pool", generators=(gen,),
                          graph=_FakeGraph(), context=_no_capture)
    assert _counters() == (launches0, routes0)       # a capture runs nothing
    assert cap.launches == {"scatter_add": 2, "score_head_sampled": 1}
    assert cap.routes == {("scatter_add", "slab"): 2}
    assert cap.graph.generators == [gen] and cap.outputs == "out"
    for n in (1, 2, 3):
        assert cap.replay() == "out"
        launches, routes = _counters()
        assert launches - launches0 == {"scatter_add": 2 * n,
                                        "score_head_sampled": n}
        assert routes - routes0 == {("scatter_add", "slab"): 2 * n}
    assert cap.replays == cap.graph.replays == 3


def test_a_failed_capture_raises_and_leaves_the_counters():
    launches0, routes0 = _counters()

    def bad():
        _fake_launches()
        raise RuntimeError("operation not permitted when stream is capturing")
    with pytest.raises(RuntimeError, match="capturing"):
        graphed.capture(bad, graph=_FakeGraph(), context=_no_capture)
    assert _counters() == (launches0, routes0)


def test_graphs_run_eager_first_then_capture_then_replay():
    def fake_capture(fn, pool=None, generators=()):
        return graphed.capture(fn, pool, generators, graph=_FakeGraph(),
                               context=_no_capture)
    graphs = graphed.Graphs(fake_capture)
    launches0, _ = _counters()

    def body(generator):
        assert generator is None
        return _fake_launches()
    assert graphs.run("a", body, None) == "out"               # eager
    assert _counters()[0] - launches0 == {"scatter_add": 2,
                                          "score_head_sampled": 1}
    for _ in range(2):
        graphs.run("a", body, None)                           # replays
    assert _counters()[0] - launches0 == {"scatter_add": 6,
                                          "score_head_sampled": 3}
    assert len(graphs) == 1 and graphs.replays == 2


def test_graphs_replay_one_graph_for_any_caller_generator():
    """A new generator on every call replays the key's one graph; the
    graph draws from its own registered generator, which takes the
    caller's state before the run, and the caller's generator leaves the
    call advanced as the eager call advances it."""
    graphs = graphed.Graphs(_rerun_out_capture)
    used = []

    def body(generator):
        used.append(generator)
        return torch.rand(5, generator=generator)
    for seed in (3, 4, 3, 4):
        gen = torch.Generator().manual_seed(seed)
        want_gen = torch.Generator().manual_seed(seed)
        want = torch.rand(5, generator=want_gen)
        assert torch.equal(graphs.run("k", body, None, gen), want)
        assert torch.equal(gen.get_state(), want_gen.get_state())
    own = graphs.by_key["k"].generators
    assert len(graphs) == 1 and graphs.replays == 3
    assert len(own) == 1 and all(u is own[0] for u in used)


def test_static_graph_copies_and_checks_shapes():
    ds = treg.get_dataset(Config(**BASE))
    batches, _, _ = driver.prepare_batches(Config(**BASE), ds, "cpu")
    by_e = collections.defaultdict(list)
    for g in batches:
        by_e[g.num_edges].append(g)
    pair = next(v for v in by_e.values() if len(v) > 1)
    bufs = graphed.StaticGraph(pair[0])
    for g in pair:
        out = bufs.load(g)
        assert out is bufs.graph
        for k, v in graphed.graph_tensors(g).items():
            assert torch.equal(getattr(out, k), v), k
            assert getattr(out, k).data_ptr() != v.data_ptr()
    other = next(v[0] for v in by_e.values() if v[0].num_edges !=
                 pair[0].num_edges)
    with pytest.raises(ValueError, match="shapes"):
        bufs.load(other)
    with pytest.raises(ValueError, match="CUDA device"):
        graphed.ShapeClasses().slot(pair[0])


# ------------------------------------ graphed control flow vs the loop


class _Rerun:
    """A fake graph whose replay reruns the captured body (the CPU's plain
    versions count no launches)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _rerun_capture(fn, pool=None, generators=()):
    return graphed.Captured(_Rerun(fn), None, collections.Counter(),
                            collections.Counter(), generators)


def _fake_classes():
    return graphed.ShapeClasses(new_pool=lambda: None)


def _batches_and_plan():
    """4 partitions in 2 shape classes; a plan with a skipped, a small and
    two sampled batches, q below every sampled batch's valid edges."""
    cfg = Config(**BASE)
    ds = treg.get_dataset(cfg)
    batches, _, _ = driver.prepare_batches(cfg, ds, "cpu")
    valid = [int(g.edge_mask.sum()) for g in batches]
    plan = [0, 1, 2, 2]
    q = min(v for v, a in zip(valid, plan) if a == 2) // 3
    return batches, plan, q, ds.num_classes


def _seed_of(n):
    return driver.batch_seed(0, 0, n)


def _reference_epoch(steps, batches, order, plan, epoch, gen):
    """The per-batch loop of ``make_train_step`` steps ({1: small, 2:
    sampled}) that the driver ran before the schedule held both routes:
    the reference both routes are held to."""
    loss_acc = torch.zeros(())
    cond_acc = torch.zeros(())
    temp = 1.0
    for bi in order:
        if plan[bi] == 0:
            continue
        gen.manual_seed(_seed_of(epoch * len(batches) + bi + 1))
        m = steps[plan[bi]](batches[bi], epoch, gen)
        loss_acc = loss_acc + m.loss
        cond_acc = cond_acc + m.conditional_update
        temp = m.temperature
    return loss_acc, cond_acc, temp


def _reference_eval(evals, batches, small, gen, stream_seed):
    """The loop of eager eval steps ({0: big, 1: small}) the driver ran
    before the schedule held both routes."""
    acc = None
    for bi, g in enumerate(batches):
        gen.manual_seed(stream_seed)
        acc = accumulate_eval_device(acc, evals[small[bi]](g, gen))
    return acc


def _epoch_step(cfg, tm, opt, q, n, route):
    """The merged epoch step on ``route`` ("loop", or "graphed" with the
    fake capture), or the reference's steps ("steps")."""
    if route == "steps":
        return {2: make_train_step(cfg, tm, opt, q, 3),
                1: make_train_step(cfg, tm, opt, q, 3, force_small=True)}
    steps = make_scan_epoch_step(cfg, tm, opt, q, 3, n, _fake_classes(),
                                 loop=route == "loop")
    if route == "graphed":
        steps.graphs = graphed.Graphs(_rerun_capture)
    return steps


@pytest.mark.parametrize("kw", [
    dict(mode="learned", pipeline="hybrid", conditional=True, reg1=True,
         reg2=True, sparse_edge_mlp=True),
    dict(mode="learned", pipeline="two_pass", conditional=True),
    dict(mode="random"), dict(mode="full"),
    dict(mode="learned", pipeline="hybrid", conditional=True, reg1=True,
         reg2=True, sparse_edge_mlp=True, dense_subgraph="on")],
    ids=["hybrid_rescore", "two_pass", "random", "full",
         "hybrid_rescore_dense"])
def test_graphed_epoch_control_flow_equals_the_loop(kw):
    """Both routes of the epoch step equal, bit for bit, the per-batch
    loop of ``make_train_step`` steps."""
    batches, plan, q, classes = _batches_and_plan()
    cfg = Config(**dict(BASE, **kw))
    n = len(batches)
    out = {}
    for route in ("steps", "loop", "graphed"):
        tm = get_model("GCN", batches[0].x.shape[1], HID, classes,
                       cfg.drop_rate, "GCN", device="cpu",
                       generator=torch.Generator().manual_seed(1))
        opt = DualOptimizer.create(tm, "GCN", cfg.lr, cfg.weight_decay)
        steps = _epoch_step(cfg, tm, opt, q, n, route)
        gen = torch.Generator()
        sums = []
        for epoch in range(3):
            order = np.random.default_rng(epoch).permutation(n).tolist()
            if route == "steps":
                acc = _reference_epoch(steps, batches, order, plan, epoch,
                                       gen)
            else:
                acc = steps(batches, order, plan, epoch, gen, _seed_of)
            sums.append([float(v) for v in acc])
        out[route] = (sums, [p.detach().clone() for p in tm.parameters()])
        if route == "loop":
            assert steps.graphs is None
        if route == "graphed":
            # one graph per (class, case) met: small in one class, sampled
            # in both; every later batch of a pair replayed
            assert len(steps.graphs) == len(
                {(batches[i].num_edges, a) for i, a in enumerate(plan) if a})
            assert steps.graphs.replays == 3 * sum(map(bool, plan)) - len(
                steps.graphs)
    sums_r, p_r = out["steps"]
    for route in ("loop", "graphed"):
        sums, params = out[route]
        assert sums == sums_r, route
        for a, b in zip(p_r, params):
            assert torch.equal(a, b), route
    for e, (_, _, t) in enumerate(sums_r):
        assert t == pytest.approx(temperature_at(e, 3, cfg.t_init,
                                                 cfg.t_min))


def test_epoch_routes_visit_the_same_batches_with_the_same_seeds():
    """The loop route and the graphed route (fake capture) of one epoch
    step: the same batches in the epoch's order, skips left out, each
    with the same case and the generator in the same state, the same
    reseeds, and the same sums."""
    batches, plan, q, classes = _batches_and_plan()
    cfg = Config(**dict(BASE, mode="learned", pipeline="hybrid",
                        conditional=True))
    n = len(batches)
    order = [3, 0, 1, 2]
    seen = {}
    for route in ("loop", "graphed"):
        tm = get_model("GCN", batches[0].x.shape[1], HID, classes,
                       cfg.drop_rate, "GCN", device="cpu",
                       generator=torch.Generator().manual_seed(1))
        opt = DualOptimizer.create(tm, "GCN", cfg.lr, cfg.weight_decay)
        steps = _epoch_step(cfg, tm, opt, q, n, route)
        visits, seeds = [], []

        def recording(case, action, visits=visits):
            def run(g, generator):
                visits.append((action, float(g.x.sum()),
                               int(g.senders.sum()),
                               generator.get_state().clone()))
                return case(g, generator)
            return run
        steps.cases = {a: recording(c, a) for a, c in steps.cases.items()}

        def seed_of(k, seeds=seeds):
            seeds.append(k)
            return _seed_of(k)
        gen = torch.Generator()
        sums = [[float(v) for v in steps(batches, order, plan, epoch, gen,
                                         seed_of)] for epoch in range(2)]
        seen[route] = (visits, seeds, sums)
    (v_l, s_l, sums_l), (v_g, s_g, sums_g) = seen["loop"], seen["graphed"]
    want = [bi for bi in order if plan[bi]]
    assert s_l == s_g == [epoch * n + bi + 1 for epoch in range(2)
                          for bi in want]
    assert [v[:3] for v in v_l] == [v[:3] for v in v_g] == [
        (plan[bi], float(batches[bi].x.sum()), int(batches[bi].senders.sum()))
        for _ in range(2) for bi in want]
    for a, b in zip(v_l, v_g):
        assert torch.equal(a[3], b[3])
    assert sums_l == sums_g


@pytest.mark.parametrize("mode", ["learned", "edge"])
def test_graphed_eval_control_flow_equals_the_loop(mode):
    """Both routes of the eval equal, bit for bit, the loop of eager eval
    steps."""
    batches, plan, q, classes = _batches_and_plan()
    cfg = Config(**dict(BASE, mode=mode))
    tm = get_model("GCN", batches[0].x.shape[1], HID, classes, 0.3, "GCN",
                   device="cpu", generator=torch.Generator().manual_seed(2))
    small = [1, 0, 1, 0]
    ref = {0: make_eval_step(cfg, tm, q),
           1: make_eval_step(cfg, tm, q, force_small=True)}
    loop = make_scan_eval_step(cfg, tm, q, loop=True)
    scan = make_scan_eval_step(cfg, tm, q, _fake_classes())
    scan.graphs = graphed.Graphs(_rerun_capture)
    gen = torch.Generator()
    for seed in (5, 6):
        want = _reference_eval(ref, batches, small, gen, seed)
        for got in (loop(batches, small, gen, seed),
                    scan(batches, small, gen, seed)):
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert loop.graphs is None
    assert len(scan.graphs) == len({(g.num_edges, s)
                                    for g, s in zip(batches, small)})


class _RerunOut(graphed.Captured):
    """Replays by rerunning the captured body and hands out its fresh
    outputs as the graph's static ones."""

    def replay(self):
        super().replay()
        return self.graph.last


class _RerunLast(_Rerun):
    def replay(self):
        self.last = self.fn()


def _rerun_out_capture(fn, pool=None, generators=()):
    return _RerunOut(_RerunLast(fn), None, collections.Counter(),
                     collections.Counter(), generators)


@pytest.mark.parametrize("which", ["sparsify", "predict"])
def test_graphed_serving_control_flow_equals_eager(monkeypatch, which):
    """``make_sparsifier`` / ``make_predictor`` with graphs, the device
    check and the capture faked on the CPU: one graph per shape, also
    with a new generator on every call; eager first call, replays after,
    copies handed out, the same outputs and generator states as the eager
    calls."""
    from sgs_gnn_tpu_torch import make_predictor, make_sparsifier
    monkeypatch.setattr(graphed, "runs_graphs", lambda device: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graphed, "capture", _rerun_out_capture)
    batches, _, q, classes = _batches_and_plan()
    cfg = Config(**BASE)
    tm = get_model("GCN", batches[0].x.shape[1], HID, classes, 0.3, "GCN",
                   device="cpu", generator=torch.Generator().manual_seed(2))
    make = make_sparsifier if which == "sparsify" else make_predictor
    fn = make(cfg, tm, q)
    eager = fn.eager
    gen_e = torch.Generator()
    last = None
    for g, seed in ((batches[2], 1), (batches[3], 2), (batches[2], 1)):
        gen_g = torch.Generator().manual_seed(seed)
        got = fn(g, gen_g)
        want = eager(g, gen_e.manual_seed(seed))
        assert type(got) is type(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(gen_g.get_state(), gen_e.get_state())
        if last is not None:        # a copy, not the graph's buffer
            assert got[0].data_ptr() != last[0].data_ptr()
        last = got
    assert batches[2].num_edges == batches[3].num_edges
    assert len(fn.graphs) == 1 and fn.graphs.replays == 2


# ---------------------------------- scan_epoch='auto' against JAX's scan


def _jax_init(cfg, in_channels, num_classes, run, device):
    jm = jax_get_model("GCN", in_channels, cfg.nhid, num_classes,
                       cfg.drop_rate, "GCN")
    x = jnp.zeros((8, in_channels), jnp.float32)
    s = jnp.arange(8, dtype=jnp.int32)
    params = init_params(jm, jax.random.PRNGKey(cfg.seed * 1000 + run), x, s,
                         s)
    tm = get_model("GCN", in_channels, cfg.nhid, num_classes, cfg.drop_rate,
                   "GCN", device=device)
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    return tm


def test_auto_epoch_on_the_cpu_matches_the_jax_scan(monkeypatch, tmp_path):
    kw = dict(BASE, mode="full", drop_rate=0.0, epochs=7, convergence=10.0,
              lr=0.01, save_csv=False, scan_epoch="auto")
    jcfg = JConfig(results_dir=str(tmp_path / "jax"), donate=False, log=True,
                   **kw)
    tcfg = Config(results_dir=str(tmp_path / "torch"), log=True, **kw)
    jlines, tlines = [], []
    (jr,) = jdriver.run_experiment(jcfg, jreg.get_dataset(jcfg),
                                   log_fn=jlines.append)
    assert any("[fastpath] scan_epoch=on (4 batches" in ln for ln in jlines)
    tds = treg.get_dataset(tcfg)
    monkeypatch.setattr(driver, "init_model", _jax_init)
    (tr,) = driver.run_experiment(tcfg, tds, log_fn=tlines.append,
                                  device="cpu")
    assert tr.epoch_route == "loop" and tr.graphs == {}
    assert any("[fastpath] epoch=per-batch loop (scan_epoch=auto on "
               "device=cpu" in ln for ln in tlines)
    assert tr.num_iterations == jr.num_iterations == 6      # early stop
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-4)
    for s in ("train", "val", "test"):
        tol = 2.0 / int(getattr(tds, f"{s}_mask").sum())
        np.testing.assert_allclose(getattr(tr, f"{s}_curve"),
                                   getattr(jr, f"{s}_curve"), rtol=0,
                                   atol=tol, err_msg=s)
        assert abs(getattr(tr, f"final_{s}_f1")
                   - getattr(jr, f"final_{s}_f1")) <= tol, s
    assert tr.total_updates == jr.total_updates


def test_epoch_route_follows_the_jax_rule():
    cfg = Config()
    assert driver.epoch_route(cfg, 4, "cpu")[0] == "loop"
    assert driver.epoch_route(cfg.replace(scan_epoch="off"), 4,
                              "cpu") == ("loop", "scan_epoch=off")
    assert driver.epoch_route(cfg, 1, "cpu")[1] == \
        "scan_epoch=auto with one batch"
    # the device is only named here; nothing runs on it
    assert driver.epoch_route(cfg, 4, torch.device("cuda", 0)) == \
        ("graphed", "scan_epoch=auto")
    assert driver.epoch_route(cfg.replace(scan_epoch="off"), 4,
                              torch.device("cuda", 0))[0] == "loop"

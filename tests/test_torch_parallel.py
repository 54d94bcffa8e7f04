"""The port's partition data-parallel path (``sgs_gnn_tpu_torch/parallel/
partitioned.py``, ``run_experiment_parallel``), the process-group start
(``parallel/distributed.py``) and the halo driver's resume, on 4 gloo
ranks on the CPU: the twins of ``tests/test_parallel.py``.

One spawn of D=4 ranks (``run_local_ranks``, the module fixture
``ranks``) runs every rank-side computation; the tests hold what
it returns against the JAX package (``make_parallel_train_step`` on
``make_mesh(4)``) and the port itself in this process, from the same
seeded numpy inputs and flax weights (``params_from_jax``). The
super-step's parity freezes sampling to fixed indices on both sides (the
``tests/test_torch_train.py`` way), with dropout, the gate and the
regularisers off; tolerances rtol 2e-4, atol 2e-5 (test_parallel.py:62's).

The module imports no JAX at its top: the ranks import it by name.
"""
import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sgs_gnn_tpu_torch import Config, get_model
from sgs_gnn_tpu_torch.data import (HostDataset, degree_prior,
                                    edge_homophily, induced_subgraphs,
                                    partition_nodes, sbm_graph,
                                    to_undirected)
from sgs_gnn_tpu_torch.eval import aggregate_eval
from sgs_gnn_tpu_torch.parallel import (backend_for, device_count,
                                        init_distributed, is_primary,
                                        local_slot_indices, make_mesh,
                                        make_parallel_eval_step,
                                        make_parallel_train_step)
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.sparsify.sampling import _normalized
from sgs_gnn_tpu_torch.train import DualOptimizer
from sgs_gnn_tpu_torch.train import pipelines

# ----------------------------------------------- W ranks, one process each


def _rank_main(fn, rank, world, store, device, timeout_s, args, results):
    torch.set_num_threads(1)
    try:
        mesh = init_distributed(
            num_processes=world, process_id=rank, device=device,
            init_method=f"file://{store}",
            timeout=datetime.timedelta(seconds=timeout_s))
        assert (mesh.world, mesh.rank) == (world, rank)
        results.put((rank, True, fn(mesh, *args)))
    except Exception:               # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_ranks(fn, world: int, store_dir, *args, device="cpu",
                    timeout_s: float = 300.0):
    """[fn(mesh_0, *args), ..., fn(mesh_{W-1}, *args)], each rank its own
    ``spawn`` process that joins a W-rank group through
    ``init_distributed`` and a file store in ``store_dir`` (no TCP port)
    with one intra-op thread; ``fn`` is a
    module-level function, its arguments and result picklable. A rank
    that raises makes the call raise with its traceback; ``timeout_s``
    bounds every collective and the whole call, and every process is
    joined within it or terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, device, timeout_s, args,
                               results), daemon=True)
             for r in range(world)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                   f"gave no result in {timeout_s} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


D = 4
Q_PARITY = 64
TRAIN_STEPS = 30
BASELINE_STEPS = 10
BASE_CONVERGENCE = dict(pipeline="hybrid", mode="learned", nhid=32,
                        epochs=25, metis_threshold=200, num_partitions=8,
                        save_csv=False, num_samples_eval=3, convergence=0.0)
BASE_DRIVER = dict(pipeline="hybrid", mode="learned", nhid=16,
                   metis_threshold=100, num_partitions=8,
                   data_parallel="on", save_csv=False, num_samples_eval=2,
                   convergence=0.0)
BASE_HALO = dict(pipeline="hybrid", mode="learned", nhid=16, halo=True,
                 save_csv=False, num_samples_eval=2, convergence=0.0,
                 checkpoint_every=2)


def fixture_arrays(n_parts):
    """test_parallel.py's ``_partitioned_fixture`` arrays and partition."""
    x, ei, y, (tr, va, te) = sbm_graph(n=400, num_classes=4, deg=12, h=0.8,
                                       seed=0)
    ei = to_undirected(ei)
    return x, ei, y, tr, va, te, partition_nodes(ei, 400, n_parts)


def partitions(n_parts):
    x, ei, y, tr, va, te, part = fixture_arrays(n_parts)
    return induced_subgraphs(x, ei, y, tr, va, te, part, n_parts,
                             device="cpu")


def host_dataset(n, seed, h, deg=10, name="test"):
    x, ei, y, (tr, va, te) = sbm_graph(n=n, num_classes=4, deg=deg, h=h,
                                       seed=seed)
    ei = to_undirected(ei)
    return HostDataset(name=name, x=x, edge_index=ei, y=y, train_mask=tr,
                       val_mask=va, test_mask=te,
                       prob=degree_prior(ei[0], ei[1], n), num_classes=4,
                       He=edge_homophily(ei, y))


def _model(nhid, state=None, dropout=0.0, scorer="GCN"):
    m = get_model("GCN", 64, nhid, 4, dropout, scorer, device="cpu")
    if state is not None:
        m.load_state_dict(state)
    return m


def _numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def frozen_sample_edges(idx):
    """``sample_edges`` with fixed indices and its weight formulas."""
    t_idx = torch.as_tensor(idx)

    def sample_edges(generator, edge_probs, prior, q, beta, istest=False,
                     edge_mask=None):
        samples = _normalized(edge_probs, edge_mask)
        if not istest:
            prior_ = torch.where(edge_mask, prior, 0.0) \
                if edge_mask is not None else prior
            samples = (1.0 - beta) * samples + beta * prior_
        sel = samples[t_idx.long()]
        st = (1.0 - sel).detach() + sel
        return t_idx, torch.clamp(edge_probs[t_idx.long()] * st, 0.0, 1.0)
    return sample_edges


def parity_cfg():
    return Config(pipeline="hybrid", mode="learned", conditional=False,
                  reg1=False, reg2=False, drop_rate=0.0, nhid=16)


def _steps(mesh, cfg, model, q, g, steps, seed):
    opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
    step = make_parallel_train_step(cfg, model, opt, q, steps, mesh)
    gen = torch.Generator()
    return [step(g, ep, seed + ep, gen) for ep in range(steps)]


def _rank_jobs(mesh, weights, idx, tmp):
    """Every rank-side computation of this file on one rank of D."""
    r = mesh.rank
    out = {}
    # the group: the launcher's, found again by init_distributed
    again = init_distributed(device="cpu")
    out["group"] = dict(mesh=(again.world, again.rank, again.backend),
                        same=again == mesh == make_mesh(D, "cpu"),
                        primary=is_primary(), slots=local_slot_indices(again),
                        count=device_count())

    # one frozen super-step (test_parallel.py:62)
    graphs = partitions(D)
    cfg = parity_cfg()
    model = _model(cfg.nhid, weights["parity"])
    sample = pipelines.sample_edges
    pipelines.sample_edges = frozen_sample_edges(idx)
    try:
        m = _steps(mesh, cfg, model, Q_PARITY, graphs[r], 1, 7)[0]
    finally:
        pipelines.sample_edges = sample
    out["parity"] = dict(params=_numpy_state(model), loss=float(m.loss))

    # trains and improves (:31), then the eval
    cfg = Config(pipeline="hybrid", mode="learned", nhid=32,
                 num_samples_eval=3)
    q = max(int(min(int(g.edge_mask.sum()) for g in graphs) * 0.5), 8)
    model = _model(32, weights["trains"], cfg.drop_rate)
    ms = _steps(mesh, cfg, model, q, graphs[r], TRAIN_STEPS, 100)
    ev = make_parallel_eval_step(cfg, model, q, mesh)
    out["trains"] = dict(losses=[float(m.loss) for m in ms],
                         eval=aggregate_eval([ev(graphs[r], 2,
                                                 torch.Generator())]))

    # q above every shard's valid edge count (:106)
    cfg = Config(pipeline="hybrid", mode="learned", nhid=16, reg1=True,
                 reg2=True, conditional=True)
    ms = _steps(mesh, cfg, _model(16, weights["parity"], cfg.drop_rate),
                graphs[r].num_edges, graphs[r], 5, 3)
    out["underfilled"] = dict(losses=[float(m.loss) for m in ms],
                              q=graphs[r].num_edges,
                              valid=int(graphs[r].edge_mask.sum()))

    # the baseline modes (:137)
    out["baseline"] = {}
    for mode in ("random", "edge", "full"):
        cfg = Config(pipeline="hybrid", mode=mode, nhid=16)
        ms = _steps(mesh, cfg, _model(16, weights["parity"], cfg.drop_rate),
                    64, graphs[r], BASELINE_STEPS, 5)
        out["baseline"][mode] = [float(m.loss) for m in ms]

    # the driver (:166, :193): convergence, updates, resume on every rank
    quiet = driver._silent
    (res,) = driver.run_experiment(
        Config(data_parallel="on", **BASE_CONVERGENCE),
        host_dataset(600, 1, 0.85, deg=14, name="conv"), log_fn=quiet,
        device="cpu")
    out["convergence"] = res.final_test_f1
    ds = host_dataset(400, 0, 0.8)
    lines = []
    (whole,) = driver.run_experiment(
        Config(epochs=6, log=True, stats=True, **BASE_DRIVER), ds,
        log_fn=lines.append, device="cpu")
    out["driver"] = dataclasses.asdict(whole)
    out["driver_lines"] = lines
    kw = dict(BASE_DRIVER, results_dir=f"{tmp}/dp", checkpoint_every=2)
    driver.run_experiment(Config(epochs=3, **kw), ds, log_fn=quiet,
                          device="cpu")
    (resumed,) = driver.run_experiment(Config(epochs=6, resume=True, **kw),
                                       ds, log_fn=quiet, device="cpu")
    out["resumed"] = dataclasses.asdict(resumed)

    # the halo driver checkpoints and resumes mid-run (:345)
    ds = host_dataset(400, 0, 0.8, name="resume_ds")
    kw = dict(BASE_HALO, results_dir=f"{tmp}/halo")
    driver.run_experiment(Config(epochs=3, **kw), ds, log_fn=quiet,
                          device="cpu")
    (halo,) = driver.run_experiment(Config(epochs=6, resume=True, **kw), ds,
                                    log_fn=quiet, device="cpu")
    out["halo_resume"] = dataclasses.asdict(halo)
    return out


@pytest.fixture(scope="module")
def setup():
    """Flax weights (as port state dicts) and the frozen sample."""
    import jax
    from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
    from sgs_gnn_tpu_torch import params_from_jax
    graphs = partitions(D)
    g0 = graphs[0]
    weights = {}
    for name, nhid, drop in (("parity", 16, 0.0), ("trains", 32, 0.3)):
        jm = jax_get_model("GCN", 64, nhid, 4, drop, "GCN")
        p = init_params(jm, jax.random.PRNGKey(0), g0.x.numpy(),
                        g0.senders.numpy(), g0.receivers.numpy())
        weights[name] = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               p))
    idx = np.sort(np.random.default_rng(3).choice(
        g0.num_edges, Q_PARITY, replace=False)).astype(np.int32)
    return weights, idx


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    weights, idx = setup
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("ranks"))
    return run_local_ranks(_rank_jobs, D, tmp, weights, idx, tmp,
                           timeout_s=900)


def test_process_group_start(ranks):
    """Each rank joined through ``init_distributed`` with its own rank;
    a second call returns the group it joined, as ``make_mesh`` does;
    rank 0 alone is primary; each rank owns its own slot."""
    for r, res in enumerate(ranks):
        g = res["group"]
        assert g["mesh"] == (D, r, "gloo") and g["same"]
        assert g["primary"] == (r == 0)
        assert g["slots"] == [r] and g["count"] == D


def test_parallel_matches_sequential_gradients(monkeypatch, setup, ranks):
    """test_parallel.py:62: one super-step (conditional off, so every
    gate passes) equals one dual-Adam step on the mean of the
    per-partition gradients (the port, in this process) and JAX's
    ``make_parallel_train_step`` on a 4-device mesh, both with the same
    frozen sample."""
    import jax
    import jax.numpy as jnp
    import sgs_gnn_tpu.train.pipelines as jax_pipelines
    from sgs_gnn_tpu.core import Config as JConfig
    from sgs_gnn_tpu.data import induced_subgraphs as jax_induced
    from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
    from sgs_gnn_tpu.parallel import (make_mesh, make_parallel_train_step
                                      as jax_parallel_step, stack_batches)
    from sgs_gnn_tpu.sparsify.sampling import _normalized as jax_normalized
    from sgs_gnn_tpu.train import DualOptimizer as JOpt
    from sgs_gnn_tpu_torch import params_from_jax
    weights, idx = setup
    for res in ranks[1:]:
        for k, v in res["parity"]["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["parity"]["params"][k])
    got = ranks[0]["parity"]["params"]

    # the port: the mean of the per-partition gradients, one step
    cfg = parity_cfg()
    model = _model(cfg.nhid, weights["parity"])
    opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
    monkeypatch.setattr(pipelines, "sample_edges", frozen_sample_edges(idx))
    loss_fn = pipelines.make_learned_loss(cfg, model, Q_PARITY)
    acc = None
    for g in partitions(D):
        total, _ = loss_fn(g, torch.Generator())
        gr = pipelines.param_grads(total, opt.params)
        acc = gr if acc is None else [a + b for a, b in zip(acc, gr)]
    opt.step_learned([a / D for a in acc], torch.ones((), dtype=torch.bool))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)

    # JAX's super-step on make_mesh(4), its sampler frozen the same way
    j_idx = jnp.asarray(idx)

    def jax_sample_edges(key, edge_probs, prior, q, beta, istest=False,
                         edge_mask=None, approx=False, bf16=True):
        samples = jax_normalized(edge_probs, edge_mask)
        if not istest:
            prior_ = jnp.where(edge_mask, prior, 0.0) \
                if edge_mask is not None else prior
            samples = (1.0 - beta) * samples + beta * prior_
        sel = samples[j_idx]
        st = jax.lax.stop_gradient(1.0 - sel) + sel
        return j_idx, jnp.clip(edge_probs[j_idx] * st, 0.0, 1.0)

    monkeypatch.setattr(jax_pipelines, "sample_edges", jax_sample_edges)
    jcfg = JConfig(pipeline="hybrid", mode="learned", conditional=False,
                   reg1=False, reg2=False, drop_rate=0.0, nhid=16,
                   donate=False)
    x, ei, y, tr, va, te, part = fixture_arrays(D)
    jgraphs = jax_induced(x, ei, y, tr, va, te, part, D)
    jm = jax_get_model("GCN", 64, 16, 4, 0.0, "GCN")
    g0 = jgraphs[0]
    params = init_params(jm, jax.random.PRNGKey(0), g0.x, g0.senders,
                         g0.receivers)
    jopt = JOpt.create(params, "GCN", jcfg.lr, jcfg.weight_decay)
    step = jax_parallel_step(jcfg, jm, jopt, Q_PARITY, 10, make_mesh(D))
    p_par, _, _ = step(params, jopt.init(params), stack_batches(jgraphs),
                       jnp.asarray(0), jax.random.PRNGKey(7))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, p_par))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_parallel_step_trains_and_improves(ranks):
    """test_parallel.py:31 on 4 ranks: 30 super-steps give a finite loss
    and the parallel eval a train F1 above 0.5, the same on every rank."""
    res = ranks[0]["trains"]
    assert len(res["losses"]) == TRAIN_STEPS
    assert np.isfinite(res["losses"]).all()
    assert res["eval"]["train_f1"] > 0.5, res["eval"]
    for other in ranks[1:]:
        assert other["trains"] == res


def test_parallel_step_underfilled_shards(ranks):
    """test_parallel.py:106: q above every shard's valid edge count (with
    the gate and both regularisers) trains with finite losses."""
    q = ranks[0]["underfilled"]["q"]
    assert q > min(res["underfilled"]["valid"] for res in ranks)
    for res in ranks:
        u = res["underfilled"]
        assert u["q"] == q and np.isfinite(u["losses"]).all(), u["losses"]


@pytest.mark.parametrize("mode", ["random", "edge", "full"])
def test_parallel_baseline_mode_step(ranks, mode):
    """test_parallel.py:137: each baseline mode's super-step (one forward
    per shard, the 'all' group) lowers the loss."""
    losses = ranks[0]["baseline"][mode]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(res["baseline"][mode] == losses for res in ranks)


def test_parallel_sequential_convergence_agreement(ranks):
    """test_parallel.py:166: data-parallel training (one update per
    super-step of 4) and the sequential schedule (one per partition)
    agree at convergence."""
    torch.set_num_threads(1)
    (seq,) = driver.run_experiment(
        Config(**BASE_CONVERGENCE),
        host_dataset(600, 1, 0.85, deg=14, name="conv"),
        log_fn=driver._silent, device="cpu")
    par = ranks[0]["convergence"]
    assert all(res["convergence"] == par for res in ranks)
    assert seq.final_test_f1 > 0.6, seq.final_test_f1
    assert par > 0.6, par
    assert abs(seq.final_test_f1 - par) < 0.15, (seq.final_test_f1, par)


def test_data_parallel_driver_path(ranks):
    """test_parallel.py:193: ``run_experiment`` with data_parallel='on'
    runs 8 partitions in super-steps of 4 (total_updates = epochs x
    parts); only rank 0 logs; a run stopped at epoch 3 (checkpoint after
    epoch 2) and resumed to 6 on every rank repeats the uninterrupted
    run."""
    res = ranks[0]["driver"]
    assert res["total_updates"] == 6 * 8
    assert res["plan"]["super_steps"] == 2 and res["plan"]["world"] == D
    assert 0.0 <= res["final_test_f1"] <= 1.0
    assert np.isfinite(res["losses"]).all()
    lines = ranks[0]["driver_lines"]
    assert any("[fastpath] epoch=per-batch loop (data_parallel over 4"
               in ln for ln in lines)
    assert any("[stats]" in ln and "parallel=4" in ln for ln in lines)
    assert all(not r["driver_lines"] for r in ranks[1:])
    for r in ranks:
        resumed = r["resumed"]
        assert resumed["start_epoch"] == 2
        for f in ("losses", "train_curve", "val_curve", "test_curve",
                  "final_test_f1"):
            assert resumed[f] == res[f], f


def test_halo_driver_resume_mid_run(ranks):
    """test_parallel.py:345: the halo driver checkpoints (epoch 1 of 3)
    and resumes to 6 epochs: 2 restored losses and 4 new, on every
    rank."""
    for r in ranks:
        res = r["halo_resume"]
        assert res["start_epoch"] == 2
        assert len(res["losses"]) == 6, res["losses"]
        assert np.isfinite(res["losses"]).all()
        assert 0.0 <= res["final_test_f1"] <= 1.0
        assert res["losses"] == ranks[0]["halo_resume"]["losses"]


class _Started(Exception):
    """Raised by the recorded ``init_process_group`` in place of a
    rendezvous."""


def test_multihost_and_torchrun_starts_reach_the_group(monkeypatch):
    """The multi-process starts, with ``init_process_group`` recorded
    in place of a rendezvous: --multihost's flags reach it through the
    CLI and the driver as ``tcp://host:port`` with their rank and world
    (gloo for --device cpu); torchrun's environment reaches it as
    ``env://``, through the driver on the CPU and, for a rank on a card,
    bound to cuda:LOCAL_RANK under NCCL."""
    from sgs_gnn_tpu_torch.parallel import distributed
    from sgs_gnn_tpu_torch.run import cli
    calls, bound = [], []

    def record(backend, **kw):
        calls.append(dict(kw, backend=backend))
        raise _Started

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", record)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(_Started):
        cli.main(["--dataset", "Karate", "--data_parallel", "on",
                  "--multihost", "--coordinator_address", "10.0.0.1:29500",
                  "--num_processes", "4", "--process_id", "3",
                  "--device", "cpu"])
    assert calls[-1] == dict(backend="gloo", rank=3, world_size=4,
                             init_method="tcp://10.0.0.1:29500")
    limit = datetime.timedelta(seconds=5)
    with pytest.raises(_Started):
        init_distributed("h:1", 2, 0, device="cpu", timeout=limit)
    assert calls[-1] == dict(backend="gloo", rank=0, world_size=2,
                             init_method="tcp://h:1", timeout=limit)

    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(_Started):
        driver.run_experiment(Config(dataset="Karate", halo=True),
                              log_fn=lambda *a: None, device="cpu")
    assert calls[-1] == dict(backend="gloo", rank=2, world_size=4,
                             init_method="env://")
    monkeypatch.setattr(distributed, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    with pytest.raises(_Started):
        init_distributed(device="cuda")
    assert bound == [torch.device("cuda", 1)]
    assert calls[-1] == dict(backend=backend_for("cuda"), rank=2,
                             world_size=4, init_method="env://",
                             device_id=torch.device("cuda", 1))
    assert len(calls) == 4


@pytest.fixture
def one_rank_group(monkeypatch):
    """The one-rank gloo group ``init_distributed`` starts in this process
    without torchrun's environment, destroyed after the test."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_group_and_its_super_step(one_rank_group):
    """Without torchrun's environment or --coordinator_address, the
    group is one rank on the caller's device (idempotent), and a
    super-step of one rank (its all-reduces the identity) is the
    sequential step on the same partition and draws, bit for bit. A
    multi-process start without a coordinator raises."""
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed("", 2, 1, device="cpu")
    mesh = init_distributed(device="cpu")
    assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
    assert init_distributed(device="cpu") == mesh and is_primary()
    from sgs_gnn_tpu_torch.parallel import rank_seed
    torch.set_num_threads(1)
    g = partitions(2)[0]
    cfg = Config(pipeline="hybrid", mode="learned", nhid=16, reg1=True,
                 reg2=True, conditional=True)
    q = int(g.edge_mask.sum()) // 2
    models = [_model(16, None, cfg.drop_rate) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    opts = [DualOptimizer.create(m, "GCN", cfg.lr, cfg.weight_decay)
            for m in models]
    par = make_parallel_train_step(cfg, models[0], opts[0], q, 5, mesh)
    seq = pipelines.make_train_step(cfg, models[1], opts[1], q, 5)
    for ep in range(3):
        mp = par(g, ep, 40 + ep, torch.Generator())
        ms = seq(g, ep, torch.Generator().manual_seed(rank_seed(40 + ep, 0)))
        assert float(mp.loss) == float(ms.loss)
        assert float(mp.conditional_update) == float(ms.conditional_update)
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k


def test_unused_partition_is_kept_and_trains_nothing(one_rank_group):
    """Under data_parallel the driver keeps a partition the packer left
    empty (the super-steps need W partitions each): its batch builds (the
    degree prior of no edges is empty; the JAX function raises there) and
    its super-step is finite."""
    assert degree_prior(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        5).shape == (0,)
    x, ei, y, tr, va, te, part = fixture_arrays(4)
    part = np.where(part == 3, 2, part)
    graphs = induced_subgraphs(x, ei, y, tr, va, te, part, 4, device="cpu")
    empty = graphs[3]
    assert not bool(empty.edge_mask.any()) and not bool(empty.train_mask.any())
    assert empty.num_edges == graphs[0].num_edges
    torch.set_num_threads(1)
    mesh = init_distributed(device="cpu")
    cfg = Config(pipeline="hybrid", mode="learned", nhid=16, reg1=True,
                 reg2=True, conditional=True)
    for g in (empty, graphs[0]):
        (m,) = _steps(mesh, cfg, _model(16, None, cfg.drop_rate), 64, g, 1, 0)
        assert bool(torch.isfinite(m.loss))

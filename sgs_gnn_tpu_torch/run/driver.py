"""Experiment driver (port of ``run/driver.py``: the equivalent of the
reference's main.py run loop), its sequential path and its two multi-rank
paths.

As in the JAX package (reference main.py:16-321):
  * partition decision: E >= metis_threshold -> num_parts =
    ceil(E / threshold) (or ``num_partitions``), q = threshold *
    sample_perc, the native partitioner (falling back to RCM), unused
    parts compacted away; else one batch with q = E * sample_perc;
  * cluster batches shuffled every epoch, class-major, from
    ``np.random.default_rng(seed + run)``;
  * per run: model and dual optimizer, the epoch loop, the ensemble eval
    per epoch, best-val tracking (with its temperature), early stop when
    std(last 5 losses) < ``convergence`` after epoch 5, the final eval on
    the best-val parameters, the ``[stats]`` line, the CSV row and the
    multi-run summary;
  * checkpoint / resume of the whole training state (``run/checkpoint.py``).

Each batch takes the sampled step or, when its VALID edge count is <= q,
the small step (``force_small``); a batch without train nodes is skipped
but counts in the loss divisor. Every batch's random draws come from one
``torch.Generator`` on the batch's device, reseeded from (seed, run,
epoch * n_batches + batch + 1), the counterpart of the JAX driver's
``fold_in``; eval draws use 2**30 + epoch and the final eval 2**31 - 1. A
batch's noise thus depends only on its global id, and a resumed run
(which also replays the skipped epochs' shuffles) repeats the run it
resumes. The epoch reads the device back once (the loss and the
conditional-update count) and the eval once per eval; the valid edge
counts and train-node flags are taken once, at preparation.

How an epoch runs, as the JAX driver decides its scan (driver.py:283-349):
with ``scan_epoch='auto'``, more than one batch and a CUDA device, the
epoch and the eval are replays of CUDA graphs (``make_scan_epoch_step``,
``make_scan_eval_step``: one graph per (shape class, case), captured after
the first eager step of the pair, sharing the class's input buffers and
memory pool); else (``'off'``, one batch, or the CPU) the per-batch loop of
eager steps. Both routes are the same schedule objects, which differ only
in whether a batch's body is captured and replayed, so they give the same
updates from the same draws. A capture
that fails raises. The ``[fastpath]`` lines name the tile kernel's and the
dense-subgraph route's engagement, the epoch's route, and why; after each
run they name the graphs captured and replayed.

The diagnostics, as in the JAX driver: ``debug_checks`` validates every
batch after preparation (``utils/debug.py``); ``gpu_profile`` profiles
the first batch with train nodes after each epoch's updates, eagerly, in
the reference's four segments (``utils/profiler.py``; a ``[gpu-profile]``
line per epoch), and turns on the port's own spans, counters and (on a
card) device stamps (``core/spans.py``) for the whole experiment, whose
tables close the log (``[spans]``, ``[stamps]``, ``[counters]`` lines:
self time per span, device time per stamped layer); ``plot_curve`` saves each run's F1 curves to
``results_dir`` (``viz/curves.py``).

The multi-rank paths run one process per rank under ``torch.distributed``
(``parallel/``): ``data_parallel='on'`` (``run_experiment_parallel``: the
cluster partitions in super-steps of W, one per rank, one synchronised
update per super-step) and ``halo`` (``run_experiment_halo``: full-graph
semantics, each rank owning a node shard and its inbound edges, one
update per epoch). The group comes from ``--multihost``'s
``--coordinator_address``/``--num_processes``/``--process_id``, else from
``torchrun``'s environment, else it is a one-rank group on the caller's
device (``parallel/distributed.py``); ``--multihost`` alone runs the
sequential path on every rank. A group that ``run_experiment`` starts, it
also ends; one the caller started stays. Only rank 0 logs and writes the CSV,
checkpoints and plots; every rank restores a checkpoint on resume. Both
loops are eager: the JAX parallel driver has no scan, so ``scan_epoch``
does not apply to them. Every flag of the JAX driver runs.
"""
from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core import graphed, spans
from ..core.graph import Graph
from ..data.partition import (induced_subgraphs, partition_nodes,
                              resolve_partitioner)
from ..data.registry import HostDataset, get_dataset
from ..eval import (accumulate_eval_device, aggregate_eval,
                    make_scan_eval_step)
from ..models import get_model
from ..ops.dense_graph import (AUTO_DEVICE_TYPES, dense_supported,
                               use_dense_subgraph)
from ..parallel.distributed import init_distributed, is_primary
from ..train import DualOptimizer, make_scan_epoch_step
from .checkpoint import TrainState, load_checkpoint, save_checkpoint


@dataclass
class RunResult:
    best_val_f1: float = 0.0
    best_test_f1: float = 0.0          # best test seen during training
    test_at_best_val: float = 0.0
    final_test_f1: float = 0.0         # after reloading best-val params
    final_train_f1: float = 0.0
    final_val_f1: float = 0.0
    train_time_sec: float = 0.0
    mean_epoch_time: float = 0.0
    num_iterations: int = 0
    conditional_updates: int = 0
    total_updates: int = 0
    losses: List[float] = field(default_factory=list)
    train_curve: List[float] = field(default_factory=list)
    val_curve: List[float] = field(default_factory=list)
    test_curve: List[float] = field(default_factory=list)
    # the port's own records of the run: what [stats] and [epoch-time]
    # print, and the batch plan of the dataset line
    epoch_times: List[float] = field(default_factory=list)
    eval_times: List[float] = field(default_factory=list)
    start_epoch: int = 0
    edges_per_s: float = 0.0
    edges_per_s_steady: float = 0.0
    peak_device_mem_mb: Optional[float] = None
    plan: dict = field(default_factory=dict)
    # "graphed" or "loop" (``epoch_route``); with graphs, what was captured
    # and replayed
    epoch_route: str = ""
    graphs: dict = field(default_factory=dict)


def want_tile_index(cfg: Config, device) -> bool:
    """Build the tile-pair edge index at preparation? It serves only the
    learned hybrid_rescore sampling pass (K6); 'auto' builds it where K6
    is the fast path, on a CUDA device; 'on' anywhere; 'off' never."""
    if cfg.tile_index == "off":
        return False
    if not (cfg.mode == "learned" and cfg.pipeline == "hybrid"
            and cfg.hybrid_rescore):
        return False
    return cfg.tile_index == "on" or torch.device(device).type == "cuda"


def prepare_batches(cfg: Config, ds: HostDataset, device="cuda",
                    build_device=None):
    """Partition decision + batch materialisation (main.py:41-67) for
    ``device``, built on ``build_device`` (default ``device``). Returns
    (batches, q, partitioner), the partitioner that ran ('native' or
    'rcm'), or None for one unpartitioned batch. Under ``data_parallel``
    unused partitions are kept (the super-steps need W of them each; an
    empty one trains nothing) and every batch pads to one shape."""
    with spans.span("data.prepare"):
        return _prepare_batches(cfg, ds, device, build_device)


def _prepare_batches(cfg: Config, ds: HostDataset, device, build_device):
    e = ds.num_edges
    tiles = want_tile_index(cfg, device)
    device = build_device or device
    if e < cfg.metis_threshold:
        q = int(e * cfg.sample_perc)
        return [Graph.build(ds.x, ds.edge_index, ds.y, ds.train_mask,
                            ds.val_mask, ds.test_mask, prob=ds.prob,
                            num_classes=ds.num_classes, sort_by_receiver=True,
                            tile_index=tiles, device=device)], q, None
    num_parts = cfg.num_partitions or int(np.ceil(e / cfg.metis_threshold))
    q = int(cfg.metis_threshold * cfg.sample_perc)
    with spans.span("data.partition"):
        method = resolve_partitioner("native")
        part = partition_nodes(ds.edge_index, ds.num_nodes, num_parts,
                               method=method)
    parallel = cfg.data_parallel == "on"
    # the degree-capped packer may leave parts unused (num_parts is a
    # ceiling, like METIS's nparts): drop them, no empty padded batches
    used = np.unique(part)
    if used.size < num_parts and not parallel:
        remap = np.full(num_parts, -1, np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        part = remap[part]
        num_parts = int(used.size)
    with spans.span("data.induce"):
        batches = induced_subgraphs(ds.x, ds.edge_index, ds.y,
                                    ds.train_mask, ds.val_mask, ds.test_mask,
                                    part, num_parts, tile_index=tiles,
                                    shape_classes=1 if parallel
                                    else cfg.shape_classes,
                                    device=device)
    return batches, q, method


def epoch_route(cfg: Config, n_batches: int, device):
    """("graphed" or "loop", why): the JAX driver's scan rule
    (``scan_epoch != 'off'`` and more than one batch) where CUDA graphs
    exist, on a CUDA device."""
    dev = torch.device(device)
    if cfg.scan_epoch == "off":
        return "loop", "scan_epoch=off"
    if n_batches <= 1:
        return "loop", f"scan_epoch={cfg.scan_epoch} with one batch"
    if not graphed.runs_graphs(dev):
        return "loop", (f"scan_epoch={cfg.scan_epoch} on device={dev.type}:"
                        " CUDA graphs need a card")
    return "graphed", f"scan_epoch={cfg.scan_epoch}"


def dense_status(cfg: Config, n: int, q: int, device) -> str:
    """The ``[fastpath] dense_subgraph=`` value: whether the learned step
    densifies its subgraphs of ``n`` nodes and q edges on ``device``
    (``ops/dense_graph.py``), and why, in the JAX driver's words."""
    dev = torch.device(device)
    if cfg.mode != "learned":
        return "off (learned mode only)"
    if not (cfg.conditional or cfg.sparse_edge_mlp):
        return "off (needs conditional or sparse_edge_mlp)"
    if not dense_supported(cfg.GNN, cfg.edge_mlp_type):
        return (f"off (no dense route for GNN={cfg.GNN}/"
                f"scorer={cfg.edge_mlp_type})")
    if use_dense_subgraph(cfg, n, q, dev):
        return (f"on (N={n}: subgraph aggregation as (N,N) matrix "
                "products)")
    if cfg.dense_subgraph == "off":
        return "off (--dense_subgraph off)"
    if n > cfg.dense_threshold:
        return f"off (N={n} > dense_threshold={cfg.dense_threshold})"
    if cfg.dense_subgraph == "auto" and dev.type not in AUTO_DEVICE_TYPES:
        return (f"off (dense_subgraph=auto on device={dev.type}: JAX's "
                "auto densifies on a TPU only; --dense_subgraph on "
                "forces it)")
    return f"off (E={q} < 4N: too sparse to amortize the adjacency build)"


def log_fastpath_status(cfg: Config, batches, q: int, device, log_fn,
                        n_trained: int = 0, epoch_line: str = "") -> None:
    """Whether the tile score kernel (K6) and the dense-subgraph route are
    engaged and why not, how the epoch runs and why (``epoch_line`` when
    given), and the device."""
    g0 = batches[0]
    dev = torch.device(device)
    if not (cfg.mode == "learned" and cfg.pipeline == "hybrid"
            and cfg.hybrid_rescore):
        tile_s = "off (serves the learned hybrid_rescore path only)"
    elif cfg.tile_index == "off":
        tile_s = "off (--tile_index off)"
    elif cfg.tile_index == "auto" and dev.type != "cuda":
        tile_s = f"off (tile_index=auto on device={dev.type}: K6 is the " \
                 "fast path on the card only)"
    elif g0.tile_t == 0:
        tile_s = "off (tile layout declined: padded slots would exceed " \
                 "1.35x E in a batch; the sampling pass scores every edge " \
                 "with K3)"
    else:
        slots = g0.tile_ls.shape[0]
        tile_s = (f"on (t={g0.tile_t} b={g0.tile_b} slots={slots} "
                  f"overhead={slots / max(g0.num_edges, 1):.2f}x)")
    log_fn(f"[fastpath] tile_score_kernel={tile_s}")
    log_fn("[fastpath] dense_subgraph="
           + dense_status(cfg, g0.num_nodes, q, dev))
    route, why = epoch_route(cfg, len(batches), dev)
    if epoch_line:
        log_fn(f"[fastpath] epoch={epoch_line}")
    elif route == "graphed":
        shapes = sorted({g.num_edges for g in batches}, reverse=True)
        sizes = [sum(g.num_edges == e for g in batches) for e in shapes]
        log_fn(f"[fastpath] epoch=graphed ({why}: {len(batches)} batches, "
               f"{n_trained} trained, shape_classes={sizes} x "
               f"edges={shapes}; one CUDA graph per (shape class, case) of "
               "the train step and of the eval, replayed per batch)")
    else:
        log_fn(f"[fastpath] epoch=per-batch loop ({why})")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    log_fn(f"[fastpath] device={dev} ({name})")


def batch_seed(seed: int, run: int, n: int) -> int:
    """The 64-bit generator seed of draw stream n of a run."""
    return int(np.random.SeedSequence([seed, run, n])
               .generate_state(1, np.uint64)[0])


def init_model(cfg: Config, in_channels: int, num_classes: int, run: int,
               device):
    """The run's model, its parameters drawn from seed * 1000 + run (the
    JAX driver's init key)."""
    return get_model(cfg.GNN, in_channels, cfg.nhid, num_classes,
                     cfg.drop_rate, cfg.edge_mlp_type, heads=cfg.gat_heads,
                     dtype=cfg.dtype, device=device,
                     generator=torch.Generator().manual_seed(
                         cfg.seed * 1000 + run))


def _epoch_order(shuffle_rng, class_members):
    """Class-major shuffle: the class visit sequence, then each class's
    batches (one class: a plain global shuffle)."""
    if len(class_members) > 1:
        class_seq = [int(c) for c in
                     shuffle_rng.permutation(len(class_members))]
    else:
        class_seq = [0]
    local = {ci: shuffle_rng.permutation(len(class_members[ci]))
             for ci in class_seq}
    return [class_members[ci][j] for ci in class_seq for j in local[ci]]


def _train_epoch(steps, batches, order, plan, epoch, gen, seed, run):
    """One epoch of ``steps`` (``make_scan_epoch_step``'s schedule, on
    either route), each batch's draws from ``batch_seed(seed, run, ...)``.
    Enqueues work only: returns the summed loss and conditional-update
    count as device scalars, and the last temperature. ``plan[bi]`` is 0
    (skip: no train nodes), 1 (small) or 2 (sampled). The driver calls it
    by name, so a caller can wrap the epoch (chip_smoke.py does)."""
    return steps(batches, order, plan, epoch, gen,
                 lambda n: batch_seed(seed, run, n))


def _evaluate(evals, batches, small, gen, stream_seed):
    """Ensemble eval of every batch on the device (``make_scan_eval_step``'s
    schedule, on either route), each batch's draws from the same seed (the
    JAX driver passes one key to every batch); called by name, as
    ``_train_epoch``."""
    return evals(batches, small, gen, stream_seed)


def _silent(*args, **kwargs):
    pass


def run_experiment(cfg: Config, ds: Optional[HostDataset] = None,
                   log_fn=print, device="cuda") -> List[RunResult]:
    cfg.validate()
    dev = resolve_device(device)
    # --gpu_profile turns the port's spans on (a caller may have already)
    profiling = cfg.gpu_profile and not spans.ON
    if profiling:
        spans.reset()
        spans.enable(device_stamps=graphed.runs_graphs(dev))
    try:
        return _route_experiment(cfg, ds, log_fn, dev)
    finally:
        if profiling:
            spans.disable()


def _route_experiment(cfg: Config, ds: Optional[HostDataset], log_fn, dev):
    if not (cfg.multihost or cfg.halo or cfg.data_parallel == "on"):
        return _run_experiment(cfg, ds, log_fn, dev, None)
    # the process group (parallel/distributed.py); a rank on a card binds
    # cuda:LOCAL_RANK
    owned = not torch.distributed.is_initialized()
    mesh = (init_distributed(cfg.coordinator_address, cfg.num_processes,
                             cfg.process_id, dev) if cfg.multihost
            else init_distributed(device=dev))
    if not mesh.primary:
        # the other ranks compute everything and stay silent; rank 0 owns
        # the log, the CSV, checkpoints and plots
        log_fn = _silent
        cfg = cfg.replace(save_csv=False, plot_curve=False)
    try:
        return _run_experiment(cfg, ds, log_fn, mesh.device, mesh)
    finally:
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run_experiment(cfg: Config, ds: Optional[HostDataset], log_fn, dev,
                    mesh) -> List[RunResult]:
    if ds is None:
        ds = get_dataset(cfg)
    if cfg.halo:
        return run_experiment_halo(cfg, ds, mesh, log_fn)
    if cfg.data_parallel == "on":
        return run_experiment_parallel(cfg, ds, mesh, log_fn)
    batches, q, partitioner = prepare_batches(cfg, ds, dev)
    if cfg.debug_checks:
        from ..utils.debug import validate_graph
        for i, b in enumerate(batches):
            validate_graph(b, name=f"batch{i}")
    n_batches = len(batches)
    # host facts of each batch, read once: the per-batch decisions never
    # wait for the card
    valid_e = [int(g.edge_mask.cpu().numpy().sum()) for g in batches]
    has_train = [bool(g.train_mask.cpu().numpy().any()) for g in batches]
    plan = [0 if not has_train[i] else (2 if valid_e[i] > q else 1)
            for i in range(n_batches)]
    small = [int(v <= q) for v in valid_e]
    shape_of = [g.num_edges for g in batches]
    class_shapes = sorted(set(shape_of), reverse=True)
    class_members = [[i for i in range(n_batches) if shape_of[i] == cs]
                     for cs in class_shapes]
    n_trained = sum(1 for a in plan if a)
    # the batch --gpu_profile profiles: the first with train nodes, so its
    # backward segment is a real one
    profile_bi = next((i for i in range(n_batches) if has_train[i]), 0)
    batch_plan = dict(parts=n_batches, q=q, partitioner=partitioner,
                      shape_classes=[[len(m), cs] for m, cs in
                                     zip(class_members, class_shapes)],
                      big=plan.count(2), small=plan.count(1),
                      skipped=plan.count(0), valid_edges=sum(valid_e))
    if cfg.log:
        log_fn(f"dataset={ds.name} N={ds.num_nodes} E={ds.num_edges} "
               f"He={ds.He:.4f} parts={n_batches} q={q} "
               f"partitioner={partitioner or 'none'}")
        log_fn(f"[batches] shape_classes={batch_plan['shape_classes']} "
               f"big={batch_plan['big']} small={batch_plan['small']} "
               f"skipped={batch_plan['skipped']} "
               f"valid_edges={batch_plan['valid_edges']}")
        log_fastpath_status(cfg, batches, q, dev, log_fn, n_trained)
    route, _ = epoch_route(cfg, n_batches, dev)

    def make_steps(model, opt):
        # the train and eval graphs of a class share its buffers and
        # memory pool
        classes, loop = graphed.ShapeClasses(), route == "loop"
        return (make_scan_epoch_step(cfg, model, opt, q, cfg.epochs,
                                     n_batches, classes, loop),
                make_scan_eval_step(cfg, model, q, classes, loop))

    shuffle = {}

    def train_epoch(steps, epoch, gen, run):
        # each run's shuffles from seed + run, one per epoch; a resumed run
        # replays the ones of the epochs it skips
        if shuffle.get("run") != run:
            shuffle.update(run=run, rng=np.random.default_rng(cfg.seed + run),
                           drawn=0)
        while shuffle["drawn"] <= epoch:
            order = _epoch_order(shuffle["rng"], class_members)
            shuffle["drawn"] += 1
        loss_acc, cond_acc, temp = _train_epoch(steps, batches, order, plan,
                                                epoch, gen, cfg.seed, run)
        # the reference divides by len(cluster_loader), skipped batches
        # included
        return loss_acc, cond_acc, temp, n_batches, n_trained

    def evaluate(evals, gen, stream_seed):
        return _evaluate(evals, batches, small, gen, stream_seed)

    def after_run(run, res, steps, evals):
        if route != "graphed":
            return
        res.graphs = dict(shape_classes=len(steps.classes),
                          train_graphs=len(steps.graphs),
                          eval_graphs=len(evals.graphs),
                          train_replays=steps.graphs.replays,
                          eval_replays=evals.graphs.replays)
        if cfg.log:
            log_fn(f"[fastpath] graphs run={run}: " + " ".join(
                f"{k}={v}" for k, v in res.graphs.items()))

    return _run_loop(cfg, ds, dev, log_fn, _Route(
        make_steps, train_epoch, evaluate, epoch_route=route,
        after_run=after_run), batches[0].x.shape[1], batch_plan,
        sum(valid_e), profile=((batches[profile_bi], q) if cfg.gpu_profile
                               else None))


def _log_segment_profile(profile, g, gen, seed, epoch, epoch_s, n_batches,
                         unit, log_fn):
    """The ``[gpu-profile]`` line of an epoch (the JAX drivers' formats):
    ``profile``'s segments on batch ``g``, its draws from ``gen`` reseeded
    with ``seed``, and the card's memory (peak: the run's). ``unit`` names
    the step: "step" (``step_time_ms`` and ``batches``), "super_step"
    (``super_step_time_ms`` and ``super_steps``) or "halo_step"
    (``halo_step_time_ms``, one per epoch)."""
    from ..utils.profiler import device_memory_mb
    gen.manual_seed(seed)
    segs, seg_mb = profile(g, gen)
    mem = device_memory_mb(g.x.device)
    mem_s = (f"allocated_mb={mem['allocated_mb']:.1f} "
             f"peak_mb={max(mem['peak_mb'], profile.peak_mb):.1f}"
             if mem else "mem=n/a")
    seg_s = " ".join(f"{k}_ms={v:.2f}" for k, v in segs.items())
    mb_s = " ".join(f"{k}_mb={v:.1f}" for k, v in seg_mb.items())
    count = {"step": f"batches={n_batches} ",
             "super_step": f"super_steps={n_batches} ",
             "halo_step": ""}[unit]
    log_fn(f"[gpu-profile] epoch={epoch} "
           f"{unit}_time_ms={epoch_s / max(n_batches, 1) * 1e3:.2f} "
           f"{count}{seg_s} {mb_s} {mem_s}")


def _device_peak_mem_mb(dev: torch.device) -> Optional[float]:
    """Peak bytes allocated by PyTorch on a CUDA device, in MiB."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / (1024 ** 2)


@dataclass
class _Route:
    """How ``_run_loop`` trains and evaluates: ``make_steps(model, opt) ->
    (steps, evals)``; ``train_epoch(steps, epoch, gen, run) -> (loss sum,
    gate count, temperature, steps, updates)``, the sums device scalars
    (the epoch's one readback); ``evaluate(evals, gen, stream_seed)`` ->
    the summed eval dict; ``after_run(run, res, steps, evals)``. ``tag`` goes
    into the checkpoint's and the plot's names, ``label`` after the run's
    number, ``stats`` into the ``[stats]`` line, ``unit`` into the
    ``[gpu-profile]`` line (``_log_segment_profile``)."""
    make_steps: Callable
    train_epoch: Callable
    evaluate: Callable
    epoch_route: str = "loop"
    tag: str = ""
    label: str = ""
    stats: str = ""
    unit: str = "step"
    after_run: Optional[Callable] = None


def _run_loop(cfg: Config, ds: HostDataset, dev, log_fn, route: _Route,
              in_channels: int, plan: dict, valid_edges: int,
              profile=None) -> List[RunResult]:
    """The runs (main.py's loop), for every route: per run the model and
    optimizer (the same on every rank: one seed), resume, the epoch loop,
    the eval per epoch and the best-val parameters, checkpoints (rank 0
    writes, every rank restores), early stop, the final eval on the
    best-val parameters, the log, ``[stats]``, the plot and the CSV.
    ``profile``: (graph, q) of ``--gpu_profile``'s segments, or None."""
    infix = f"_{route.tag}" if route.tag else ""
    results: List[RunResult] = []
    for run in range(cfg.runs):
        model = init_model(cfg, in_channels, ds.num_classes, run, dev)
        opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
        steps, evals = route.make_steps(model, opt)
        gen = torch.Generator(device=dev)
        seg_profile = None
        if profile is not None:
            from ..utils.profiler import make_segment_profiler
            seg_profile = make_segment_profiler(cfg, model, profile[1])

        res = RunResult(plan=plan, epoch_route=route.epoch_route)
        best_state = None
        best_temp = 0.0
        epoch_times = res.epoch_times
        num_iteration = cfg.epochs
        start_epoch = 0
        ckpt_path = os.path.join(
            cfg.results_dir, "ckpt",
            f"{cfg.dataset}_{cfg.mode}_{cfg.pipeline}{infix}_run{run}.pt")
        if cfg.resume:
            st = load_checkpoint(ckpt_path, dev)
            if st is not None:
                model.load_state_dict(st.params)
                opt.load_state_dict(st.opt_state)
                start_epoch = st.epoch + 1
                res.best_val_f1 = st.best_val_f1
                res.test_at_best_val = st.test_at_best_val
                res.best_test_f1 = st.best_test_f1
                best_temp = st.best_temperature
                res.losses = list(st.losses)
                res.train_curve = list(st.train_curve)
                res.val_curve = list(st.val_curve)
                res.test_curve = list(st.test_curve)
                best_state = st.best_params or {
                    k: v.detach().clone()
                    for k, v in model.state_dict().items()}
                if cfg.log:
                    log_fn(f"resumed run {run} from epoch {start_epoch} "
                           f"(best_val_f1={st.best_val_f1:.4f})")
        res.start_epoch = start_epoch

        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            with spans.span("run.epoch", epoch):
                loss_acc, cond_acc, temp, n_steps, n_updates = \
                    route.train_epoch(steps, epoch, gen, run)
            res.total_updates += n_updates
            with spans.span("run.readback", epoch):
                loss_sum, cond = torch.stack([loss_acc, cond_acc]).tolist()
            loss = loss_sum / n_steps
            res.conditional_updates += int(cond)
            res.losses.append(loss)
            epoch_times.append(time.perf_counter() - t0)
            if cfg.stats and cfg.log and epoch < 16:
                log_fn(f"[epoch-time] epoch={epoch} "
                       f"sec={epoch_times[-1]:.3f}")
            if seg_profile is not None:
                _log_segment_profile(seg_profile, profile[0], gen,
                                     batch_seed(cfg.seed, run, 2**29 + epoch),
                                     epoch, epoch_times[-1], n_steps,
                                     route.unit, log_fn)

            if cfg.eval:
                t1 = time.perf_counter()
                with spans.span("run.eval", epoch):
                    agg = aggregate_eval([route.evaluate(
                        evals, gen, batch_seed(cfg.seed, run,
                                               2**30 + epoch))])
                res.eval_times.append(time.perf_counter() - t1)
                if cfg.stats and cfg.log and epoch < 16:
                    log_fn(f"[eval-time] epoch={epoch} "
                           f"ms={res.eval_times[-1] * 1e3:.1f}")
                tr_f1, va_f1, te_f1 = (agg["train_f1"], agg["val_f1"],
                                       agg["test_f1"])
                res.train_curve.append(tr_f1)
                res.val_curve.append(va_f1)
                res.test_curve.append(te_f1)
                if va_f1 >= res.best_val_f1:
                    res.best_val_f1 = va_f1
                    res.test_at_best_val = te_f1
                    # a copy on the device: no host transfer per improvement
                    with spans.span("run.best_model", epoch):
                        best_state = {k: v.detach().clone()
                                      for k, v in model.state_dict().items()}
                    best_temp = temp
                    if cfg.log:
                        log_fn(f"*Epoch {epoch}, model saved with Loss: "
                               f"{loss:.4f}, Train F1: {tr_f1:.4f}, Val F1: "
                               f"{va_f1:.4f}, Test F1: {te_f1:.4f}")
                res.best_test_f1 = max(res.best_test_f1, te_f1)
                if cfg.log and epoch % 100 == 0:
                    log_fn(f"Epoch {epoch}, Loss: {loss:.4f}, Train F1: "
                           f"{tr_f1:.4f}, Val F1: {va_f1:.4f}, Test F1: "
                           f"{te_f1:.4f}")

            if cfg.checkpoint_every and \
                    (epoch + 1) % cfg.checkpoint_every == 0:
                with spans.span("run.checkpoint", epoch):
                    if is_primary():
                        save_checkpoint(ckpt_path, TrainState(
                            params=model.state_dict(),
                            opt_state=opt.state_dict(), epoch=epoch,
                            best_val_f1=res.best_val_f1,
                            test_at_best_val=res.test_at_best_val,
                            best_temperature=best_temp, losses=res.losses,
                            best_params=best_state,
                            best_test_f1=res.best_test_f1,
                            train_curve=res.train_curve,
                            val_curve=res.val_curve,
                            test_curve=res.test_curve))
                    if torch.distributed.is_initialized():
                        # no rank runs ahead of a checkpoint being written
                        torch.distributed.barrier()

            if epoch >= 5 and float(np.std(res.losses[-5:])) < \
                    cfg.convergence:
                num_iteration = epoch + 1
                break

        res.num_iterations = num_iteration
        res.train_time_sec = float(np.sum(epoch_times))
        res.mean_epoch_time = float(np.mean(epoch_times)) \
            if epoch_times else 0.0

        # reload the best-val parameters for the final ensemble eval
        # (main.py:264-270)
        if best_state is not None:
            with spans.span("run.best_model"):
                model.load_state_dict(best_state)
        with spans.span("run.eval"):
            agg = aggregate_eval([route.evaluate(
                evals, gen, batch_seed(cfg.seed, run, 2**31 - 1))])
        res.final_train_f1 = agg["train_f1"]
        res.final_val_f1 = agg["val_f1"]
        res.final_test_f1 = agg["test_f1"]
        if route.after_run is not None:
            route.after_run(run, res, steps, evals)

        log_fn(f"Run: {run}{route.label}")
        log_fn(f"Mean epoch time of run {res.mean_epoch_time:.4f}")
        log_fn(f"Iteration:  {res.num_iterations}")
        log_fn(f"EdgeMLP updated {res.conditional_updates}/"
               f"{res.total_updates}")
        log_fn(f"Best Test F1 throughout: {res.best_test_f1:.4f}")
        log_fn(f"Best Test F1 after loading saved model: "
               f"{res.final_test_f1:.4f}")
        # edges/s = valid (unpadded) edges trained per second; steady =
        # over the median epoch (the first one holds the warm-up)
        res.edges_per_s = valid_edges / max(res.mean_epoch_time, 1e-9)
        res.edges_per_s_steady = (
            valid_edges / max(float(np.median(epoch_times)), 1e-9)
            if epoch_times else 0.0)
        res.peak_device_mem_mb = _device_peak_mem_mb(dev)
        if seg_profile is not None and res.peak_device_mem_mb is not None:
            # the profiler's resets of the peak statistics: the run's peak
            # is the larger of the peaks read before and after them
            res.peak_device_mem_mb = max(res.peak_device_mem_mb,
                                         seg_profile.peak_mb)
        if cfg.stats:
            mem = res.peak_device_mem_mb
            mem_s = f"{mem:.2f}" if mem is not None else "NA"
            log_fn(f"[stats] pipeline={cfg.pipeline} run={run} "
                   f"{route.stats}"
                   f"train_time_sec={res.train_time_sec:.4f} "
                   f"edges_per_s={res.edges_per_s:.0f} "
                   f"edges_per_s_steady={res.edges_per_s_steady:.0f} "
                   f"peak_device_mem_mb={mem_s} "
                   f"best_val_f1={res.final_val_f1:.4f} "
                   f"best_test_f1={res.final_test_f1:.4f}")
        if cfg.plot_curve and res.train_curve:
            from ..viz import plot_learning_curves
            os.makedirs(cfg.results_dir, exist_ok=True)
            plot_learning_curves(
                run, res.train_curve, res.val_curve, res.test_curve,
                path=os.path.join(cfg.results_dir, f"curves_{ds.name}_"
                                  f"{cfg.mode}{infix}_run{run}.png"))
        if cfg.save_csv:
            _append_csv(cfg, ds, run, res)
        results.append(res)

    _summary(cfg, results, log_fn)
    if cfg.gpu_profile and spans.ON:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for line in spans.report_lines(spans.collect()):
            log_fn(line)
    return results


def run_experiment_parallel(cfg: Config, ds: HostDataset, mesh,
                            log_fn=print) -> List[RunResult]:
    """Partition data-parallel experiment (JAX driver.py:640-857): the
    partitions, rounded up to a multiple of W, in super-steps of W; rank r
    trains ``batches[i + r]`` of the super-step starting at i
    (``parallel/partitioned.py``), one synchronised update per super-step;
    the eval sums every rank's partitions. Each super-step samples q
    (clamped to the padded edge count) on every partition: a partition
    with fewer valid edges than q takes them all (padding selections
    weigh nothing), the reference's small-batch branch subsumed."""
    from ..parallel import make_parallel_eval_step, make_parallel_train_step
    from ..utils.debug import validate_graph
    w, dev = mesh.world, mesh.device
    parts = cfg.num_partitions or max(
        w, int(np.ceil(ds.num_edges / cfg.metis_threshold)))
    cfg_p = cfg.replace(num_partitions=int(np.ceil(parts / w) * w))
    # a rank keeps only its own partitions: with several ranks they are
    # built on the host and the rank's moved to its device
    batches, q, partitioner = prepare_batches(
        cfg_p, ds, dev, build_device=dev if w == 1 else "cpu")
    if len(batches) == 1:
        raise ValueError("data_parallel=on needs a partitioned graph; lower "
                         "--metis_threshold or set --num_partitions")
    if len(batches) % w:
        raise ValueError(f"{len(batches)} partitions do not fill "
                         f"super-steps of {w} ranks")
    q = min(q, batches[0].num_edges)
    valid_edges = sum(int(g.edge_mask.sum()) for g in batches)
    n_groups = len(batches) // w
    local = [g.to(dev) for g in batches[mesh.rank::w]]
    del batches
    if cfg.debug_checks:
        for i, g in enumerate(local):
            validate_graph(g, name=f"batch{i * w + mesh.rank}")
    plan = dict(parts=n_groups * w, q=q, partitioner=partitioner, world=w,
                super_steps=n_groups, shape_classes=[[n_groups * w,
                                                      local[0].num_edges]],
                valid_edges=valid_edges)
    if cfg.log:
        log_fn(f"dataset={ds.name} N={ds.num_nodes} E={ds.num_edges} "
               f"He={ds.He:.4f} parts={plan['parts']} ranks={w} "
               f"super_steps/epoch={n_groups} q={q} "
               f"partitioner={partitioner}")
        log_fastpath_status(
            cfg, local, q, dev, log_fn, epoch_line=(
                f"per-batch loop (data_parallel over {w} ranks: {n_groups} "
                "eager super-steps per epoch, one all-reduce each; the JAX "
                "parallel driver has no scan, so scan_epoch does not "
                "apply)"))

    def make_steps(model, opt):
        return (make_parallel_train_step(cfg, model, opt, q, cfg.epochs,
                                         mesh),
                make_parallel_eval_step(cfg, model, q, mesh))

    def train_epoch(step, epoch, gen, run):
        loss_acc = torch.zeros((), device=dev)
        cond_acc = torch.zeros((), device=dev)
        temp = 1.0
        for gi, g in enumerate(local):
            m = step(g, epoch,
                     batch_seed(cfg.seed, run, epoch * n_groups + gi + 1),
                     gen)
            loss_acc = loss_acc + m.loss
            cond_acc = cond_acc + m.conditional_update
            temp = m.temperature
        return loss_acc, cond_acc, temp, n_groups, n_groups * w

    def evaluate(ev, gen, stream_seed):
        acc = None
        for g in local:
            acc = accumulate_eval_device(acc, ev(g, stream_seed, gen))
        return acc

    return _run_loop(cfg, ds, dev, log_fn, _Route(
        make_steps, train_epoch, evaluate, tag="par",
        label=f" (data-parallel x{w})", stats=f"parallel={w} ",
        unit="super_step"),
        local[0].x.shape[1], plan, valid_edges,
        profile=(local[0], q) if cfg.gpu_profile else None)


# the halo route's --gpu_profile runs whole-graph segments stand-alone;
# past this many edges the JAX driver skips them (one chip's memory)
HALO_PROFILE_MAX_EDGES = 5_000_000


def run_experiment_halo(cfg: Config, ds: HostDataset, mesh,
                        log_fn=print) -> List[RunResult]:
    """Halo-exchange experiment (JAX driver.py:859-1042): each rank owns a
    node shard of the native partition into W parts and all its inbound
    edges, the layers exchange boundary rows (``parallel/halo_train.py``),
    so the W ranks compute the full graph's semantics; one synchronised
    step per epoch."""
    from ..parallel import (build_halo_batch, make_halo_eval_step,
                            make_halo_train_step)
    w, dev = mesh.world, mesh.device
    hb = build_halo_batch(ds.x, ds.edge_index, ds.y, ds.train_mask,
                          ds.val_mask, ds.test_mask, ds.prob, w,
                          ds.num_classes, sample_perc=cfg.sample_perc,
                          rank=mesh.rank, device=dev)
    plan = dict(world=w, q_loc=hb.q_loc, round_sizes=list(hb.round_sizes),
                ext_rows=hb.ext_rows, gather_rows=hb.gather_rows,
                valid_edges=hb.valid_edges)
    if cfg.log:
        log_fn(f"dataset={ds.name} N={ds.num_nodes} E={ds.num_edges} "
               f"halo ranks={w} q_loc={hb.q_loc}")
        saved = 1.0 - hb.ext_rows / max(hb.gather_rows, 1)
        log_fn(f"[fastpath] halo_exchange=all_to_all "
               f"rows_per_exchange={hb.ext_rows} "
               f"vs_all_gather={hb.gather_rows} "
               f"({100 * saved:.1f}% traffic saved; "
               f"rounds={list(hb.round_sizes)})")
        log_fn("[fastpath] epoch=per-batch loop (halo: one eager step per "
               "epoch; the JAX halo driver has no scan, so scan_epoch does "
               "not apply)")
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "host")
        log_fn(f"[fastpath] device={dev} ({name})")
    profile = None
    if cfg.gpu_profile:
        if ds.num_edges <= HALO_PROFILE_MAX_EDGES:
            profile = (Graph.build(ds.x, ds.edge_index, ds.y, ds.train_mask,
                                   ds.val_mask, ds.test_mask, prob=ds.prob,
                                   num_classes=ds.num_classes, device=dev),
                       hb.q_loc * w)
        else:
            log_fn(f"[gpu-profile] skipped: E={ds.num_edges} > "
                   f"{HALO_PROFILE_MAX_EDGES} (whole-graph stand-alone "
                   "segments)")

    def make_steps(model, opt):
        return (make_halo_train_step(cfg, model, opt, cfg.epochs, mesh),
                make_halo_eval_step(cfg, model, mesh))

    def train_epoch(step, epoch, gen, run):
        m = step(hb, epoch, batch_seed(cfg.seed, run, epoch + 1), gen)
        return m.loss, m.conditional_update, m.temperature, 1, 1

    def evaluate(ev, gen, stream_seed):
        return ev(hb, stream_seed, gen)

    return _run_loop(cfg, ds, dev, log_fn, _Route(
        make_steps, train_epoch, evaluate, tag="halo",
        label=f" (halo x{w})", stats=f"halo={w} ", unit="halo_step"),
        ds.x.shape[1], plan,
        hb.valid_edges, profile)


def _append_csv(cfg: Config, ds: HostDataset, run: int, res: RunResult):
    """Results/<dataset>/<sample_perc>.csv append (main.py:295-306)."""
    d = os.path.join(cfg.results_dir, ds.name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{cfg.sample_perc}.csv")
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["run", "iter", "he", "mode", "loss", "train_f1",
                        "val_f1", "test_f1"])
        w.writerow([run, res.num_iterations, ds.He, cfg.mode,
                    res.losses[-1] if res.losses else 0.0,
                    res.final_train_f1, res.final_val_f1, res.final_test_f1])


def _summary(cfg: Config, results: List[RunResult], log_fn):
    log_fn("---------------Stats-----------")
    log_fn(f"Mean training epoch runtime: "
           f"{np.mean([r.mean_epoch_time for r in results]):.4f}")
    its = [r.num_iterations for r in results]
    log_fn(f"Mean convergence number: {np.mean(its):.4f} +/- "
           f"{np.std(its):.4f}, {its}")
    if cfg.mode == "learned":
        log_fn(f"EdgeMLP updated/Total GNN updates "
               f"{np.round(np.mean([r.conditional_updates for r in results]))}"
               f"/{np.round(np.mean([r.total_updates for r in results]))}")
    bt = [r.best_test_f1 for r in results]
    tv = [r.test_at_best_val for r in results]
    ft = [r.final_test_f1 for r in results]
    log_fn(f"Mean Std of Best Test we could do F1 Score: {np.mean(bt):.4f} "
           f"+/- {np.std(bt):.4f}")
    log_fn(f"Mean Std of Test at best Val F1 Score: {np.mean(tv):.4f} +/- "
           f"{np.std(tv):.4f}")
    log_fn(f"Mean Std of Loaded best Val model Test F1 Score: "
           f"{np.mean(ft):.4f} +/- {np.std(ft):.4f}")
    log_fn("-------------------------------")

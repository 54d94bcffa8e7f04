#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sgs_gnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   the card (name and power limit from nvidia-smi), the build of
              the CUDA kernels from the sources in this checkout.
     sass     the tensor-core head kernels (bf16 K3 and K6,
              csrc/head_mma.cuh; bf16 K5's three kernels,
              csrc/head_bwd_mma.cuh) as built: registers, spills and stack
              from the build log's ptxas lines, dynamic shared memory, and
              their HGMMA / HMMA instructions counted in ``cuobjdump -sass``
              of the library (a count of 0 fails the run).
  2. kernel   each kernel of the serving and training paths against its
              plain PyTorch version on the card at the path's shapes: K1
              and K2 on the ids each path feeds them (``row_cases``: the
              prior-sampled receivers and senders at q=200k, F=256 and 41,
              the sorted sample, E=1M receiver-sorted and unsorted senders;
              the other backbones' and scorers' f32 sums: F=602 and F=256
              on the sampled receivers, F=256 and K2 on them with one
              self-loop per node appended, GAT's E=q+N;
              each with its route and, on the slab route, its chunks per
              mode, counted by the kernel and held against the twin of its
              pick), the head kernels (K3 at E=1M without
              and with dropout 0.3, K3 with a sorted side, K5, K6 with
              dropout 0.3; kernel and plain
              version draw the same mask), the sorted scatter K7 (with a
              ragged E, a band too narrow and padding ids) and the fused
              SpMM K8 (F=256 and 41, weighted and not, the receiver-sorted
              edge list and its reversal, bf16 on the tile route; the
              coalesced list; f32 on the gather route; each with its route,
              the binning's own device time, torch.sparse.mm's device time
              and whether K8's is below it): error against the stated
              tolerance, and times (CUDA events over back-to-back wrapper
              calls) of the kernel, the plain version and one PyTorch
              library call of the same work where one exists, the kernel's
              own device time from torch.profiler (K5: per kernel), beside
              the kernel's bound on an H100 SXM.
  3. fused_spmm  GCNConv(backend="fused") forward + backward at the
              scorer's and the backbone's widths, launch-counted (K8's
              routes too), against backend="auto" (outputs and gradients).
  4. serve    sparsify + predict (11 draws) at the bench partition's full
              width (N=2048, E=1M, 602 features, nhid 256, 41 classes,
              q=200k, bf16) with random weights from a seed; launch counts of
              that one run (K1's and K2's also per route, K1's slab chunks
              per mode as the kernel counted them) and, from a second run
              with the same draws, K1's and K2's calls per id case;
              outputs checked for shape and finiteness and against the same
              port run on the CPU in f32. On the card both calls replay
              a CUDA graph (captured after the first, eager, call): the
              steady times of the graphed calls and of the eager ones
              (their ``eager`` attribute) in turns, and graphed against
              eager from one seed (shared edges, logits). One more call of
              each under torch.profiler (a ``profile`` line each, predict
              also eager): device time by kernel, device busy time and
              idle share.
  5. train    the learned training step of bench.py's workload
              (conditional, sparse_edge_mlp, reg1, reg2, dropout 0.3) on the
              same partition, for each pipeline of the learned mode:
              hybrid_rescore (with the tile index, 20 timed steps),
              straight_through, the exact hybrid without and with
              hybrid_checkpoint, and two_pass (10 timed steps each): one
              warm-up step, the launch counts of one step (K1's and K2's
              also per route and per id case, K1's slab chunks per mode)
              against the counts
              the path implies, the timed steps (finite losses, parameters
              moved, peak memory) and a ``profile`` line (one step under
              torch.profiler) each; the same step as a CUDA graph
              (make_scan_epoch_step over the one batch: a replay under
              no_host_sync with the eager step's launch counts, timed
              replays, the graph's memory, a ``profile`` line; the
              ``graphed`` entry of the train line); then, after every
              timed path, for
              hybrid_rescore, straight_through and the exact hybrid one
              frozen-sample step without dropout whose loss and gradients
              are held against the port on the CPU in f32 (a ``grad_check``
              line).
  5b. models  one hybrid_rescore step (tile index, bench.py's flags, the
              train phase's partition at nhid 256, bf16, gat_heads 1) of
              each of the 12 backbone x scorer pairs of
              Scripts/run_ablation_tpu.sh (GCN, GIN, GAT, Cheb x MLP,
              GSAGE, GCN): a warm-up step, one launch-counted step under
              no_host_sync held to ``model_launches`` (derived from the
              layers' code), 5 timed steps (finite losses, parameters
              moved, peak memory) and a ``model`` line each. GAT + GSAGE
              and GIN + MLP also run graphed (launch counts equal to the
              eager step's), with a ``profile`` line per route, and a
              ``grad_check`` each (the train phase's limits).
  5c. dense   dense_subgraph='on' (the subgraphs densified into (N, N)
              adjacencies, ops/dense_graph.py) on the same partition for
              hybrid_rescore, two_pass and GAT + GCN: the train phase's
              path as a ``dense`` line each (launches held to
              ``dense_launches``, derived from the code: K1 and K2 of the
              scorer's encoder and of the random forward are gone; eager
              and graphed step times, busy and idle, peak memory), a
              ``dense_routes`` line (K1 and K2 per step on each route),
              a ``dense_parity`` line each (frozen sample, no dropout,
              'on' against 'off' on the card: loss and every gradient
              within the stated limits) and a ``dense_ops`` line (the
              (N, N) build and the (N, N) @ (N, 256) bf16 product, each
              beside its bound and the K1 launch it replaces).
  6. experiment  the CLI's path at full width: the port's
              community_sbm_graph (9,100 nodes, 602 features, 41 classes,
              ~4.5M directed edges) through run_experiment with
              Scripts/run_reddit_scale.sh's flags (parsed by the port's
              CLI parser; bf16, nhid 256, metis_threshold 1M: 5 native
              partitions, q=200k), 2 epochs each of learned (hybrid_rescore
              with the tile index), random, edge and full, each graphed
              (scan_epoch=auto: CUDA graphs per shape class and case) and
              eager (scan_epoch=off) in turns: a ``padded_rows``
              line first (K1 and K2 against their plain versions on the
              most-padded partition's ids, ghost-node run included), then an
              ``experiment`` line per mode and route (route, graphs
              captured and replayed, parts, q, shape classes,
              batches big / small / skipped, epoch and eval times,
              edges/s steady, losses, final F1s, peak memory, launches per
              epoch by kernel; learned must launch K1-K6, the baselines K1
              and K2 only; the native partitioner must have run; the batch
              loop of epoch 1 runs under no_host_sync); the CSV must hold
              one row per mode; an ``experiment_routes`` line per mode
              holds graphed against eager (launches per epoch equal,
              losses and F1s within the stated limits) with both routes'
              epoch and eval times; the eager learned run's third epoch is
              profiled; then learned resumed (graphed) from its
              every-epoch checkpoint to epoch 4 (must start at epoch 2
              with the restored losses), its epoch-3 replays profiled;
              then learned with the GAT backbone and the GraphSAGE scorer
              (``--GNN GAT --edge_mlp_type GSAGE``), 2 epochs graphed and
              eager: an ``experiment`` line each and an
              ``experiment_routes`` line (launches equal, F1s within the
              same limit, losses within MODEL_EXPERIMENT_LOSS_RTOL, set
              from that pair's own run-to-run spread); last, learned with
              Scripts/run_memory.sh's flags and --debug_checks (every
              batch validated; each epoch's ``[gpu-profile]`` line with
              the four segments' ms and MiB; the ``[stats]`` peak not
              lowered by the profiler); an ``eval_step`` line
              (``make_eval_step`` of the learned run timed alone over
              every partition, and profiled).
  7. quality  tests/test_quality.py's configuration (SyntheticSBMLow, f32,
              nhid 64, 60 epochs) through run_experiment for learned,
              random and full: learned must beat random by 0.2 and full by
              0.1 in final test F1; printed beside the JAX package's F1s
              in the same configuration (``QUALITY_JAX_REFERENCE``).
  7b. baselines  NeuralSparseGCN and SparseGAT (baselines/) on the bench
              partition at tools/baseline_compare.py's widths (f32, hidden
              64, k = round(0.2 E / N), L0 weight 1e-3): one forward and
              backward against the CPU port from equal parameters and one
              fixed Gumbel draw (the CPU takes the card's keep mask, which
              is held bit for bit to the CPU's top-k of the card's
              scores), then Adam steps timed, launch-counted, with peak
              memory and SparseGAT's kept-edge share: a ``baselines``
              line each.
  7c. embeddings  viz.extract_embeddings ('hidden' and 'logits') of GCN,
              GIN and GAT backbones at nhid 256 in bf16 on the bench
              partition against the CPU port in f32 (an ``embeddings``
              line each, launches held to ``embedding_launches``).
  8. parallel  the multi-rank paths' process group on the card: one rank
              under NCCL (one card, and NCCL takes one rank per device),
              started by ``init_distributed``; its bucketed all-reduce must
              return its input bit for bit; one data-parallel super-step
              (``make_parallel_train_step``, hybrid_rescore at the train
              phase's shapes) against the sequential step from equal
              parameters and draws (loss within PARALLEL_LOSS_RTOL, every
              gradient the optimizer gets within PARALLEL_GRAD_REL; a
              second sequential copy gives the reordering floor), a
              launch-counted super-step under
              no_host_sync held to the sequential step's counts, both
              timed in turns and profiled: a ``parallel_step`` line.
              Then, on the experiment graph, a ``halo_step`` line (one
              full-mode halo step on the whole graph against the
              full-graph step, f32, equal parameters and draws; timed in
              turns, profiled) and an ``experiment`` line each for learned
              ``--data_parallel on`` (K1-K6), learned ``--halo`` (K1, K2,
              K3, K5) and full ``--halo`` (K1, K2), 2 epochs each. Right
              after the super-step, in its group, ``tensor_parallel``:
              shard_params_tp at tp = 1 (make_dp_tp_mesh(1, 1)) on the
              bench partition without a tile index, one step against the
              sequential step (sample frozen, no dropout, no gate; bf16
              limits, a second sequential copy's gap beside them), a
              launch-counted step (K1 16, K2 6, no head kernel), both
              steps with bench.py's dropout timed in turns, profiled, with
              their peaks. Last, so no earlier measurement runs beside
              the process group.

Then a ``kernels`` line (one entry per TPU kernel of the JAX package: route,
the units it runs on, source, the TPU kernel it replaces, launches on each
path, error, times and the share of its bound)
and, last, the ok line. Any failed check raises and the script exits
nonzero without the ok line; without a card it exits 1 before doing
anything.
"""
import contextlib
import gc
import importlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

N_NODES, N_EDGES, FEAT, CLASSES, NHID, Q, DRAWS = (2048, 1_000_000, 602, 41,
                                                   256, 200_000, 11)
CPU_SUBSAMPLE = 65_536     # edges scored by the CPU f32 reference
DROP = 0.3                 # Config.drop_rate, the head kernels' dropout
DEVICE = "cuda"            # the card (a CPU rehearsal sets "cpu")
TRAIN_STEPS = 20           # timed steps of hybrid_rescore
PIPELINE_STEPS = 10        # timed steps of each other pipeline
GRAD_REL_TOL = 0.05        # grad_check: relative L2, card bf16 vs CPU f32
PROFILER_ATTEMPTS = 3      # traces of a kernel timing before giving up
FUSED_REL_TOL = 1e-2       # GCNConv fused vs auto: relative L2, bf16
HEAD_MMA_KERNEL = "head_mma_kernel"   # bf16 K3 / K6 (csrc/head_mma.cuh)
# bf16 K5's three kernels (csrc/head_bwd_mma.cuh)
HEAD_BWD_KERNELS = ("head_bwd_mma_dz1_kernel", "head_bwd_mma_dh_kernel",
                    "head_bwd_mma_dw_kernel")
# the device functions each wrapper launches (profiler names hold them)
KERNEL_FUNCS = {
    "scatter_add": ("scatter_slab_kernel", "scatter_direct_kernel"),
    "segment_sum_scalar": ("segment_sum_kernel",),
    "score_head_sampled": (HEAD_MMA_KERNEL,),
    "score_head_sampled_banded": (HEAD_MMA_KERNEL,),
    "score_head_bwd": HEAD_BWD_KERNELS,
    "score_head_tiles": (HEAD_MMA_KERNEL,),
    "scatter_add_sorted": ("scatter_sorted_kernel",),
    # the gather route; the tile route's binning (count, scatter) and tiles
    "spmm_fused": ("spmm_kernel", "spmm_bin_count_kernel",
                   "spmm_bin_scatter_kernel", "spmm_tile_kernel"),
}
SPMM_BIN_FUNCS = ("spmm_bin_count_kernel", "spmm_bin_scatter_kernel")
# The learned pipelines, each with bench.py's flags, and the launches of one
# step (conditional, sparse_edge_mlp, reg1, reg2). In every pipeline K1
# runs once in each GCN layer's SpMM and once in each backward of one that
# has gradients, plus the 2 row gathers of reg2; K2 once in each GCN layer
# (its backward is a row gather, no launch).
#   hybrid_rescore (tile index): 6 layers with gradients (scorer encoder 2,
#     learned backbone 2, random backbone 2): K1 6 + 6 + 2; K6 scores every
#     tile slot; the head on the q sorted winners is K3 with a sorted side
#     (row 4, "banded") and K5.
#   straight_through, hybrid exact (with or without remat): the same 6
#     layers; the unfused head over every edge gathers both endpoints, its
#     backward is K1 on the senders (+1) and K7 on the sorted receivers.
#   two_pass: pass 1 (no gradients) runs the encoder (2 layers, K1 and K2
#     forward only) and K3 over every edge; pass 3 re-runs the encoder on
#     the sampled subgraph with gradients and the head on the winners (K3
#     with the receivers sorted, K5): K1 8 + 6 + 2, K2 8.
_ROWS = {"scatter_add": 14, "segment_sum_scalar": 6}
_UNFUSED = dict(_ROWS, scatter_add=15, scatter_add_sorted=1)
PIPELINES = {
    "hybrid_rescore": (dict(pipeline="hybrid"), TRAIN_STEPS, dict(
        _ROWS, score_head_tiles=1, score_head_sampled_banded=1,
        score_head_bwd=1)),
    "straight_through": (dict(pipeline="straight_through"), PIPELINE_STEPS,
                         _UNFUSED),
    "hybrid_exact": (dict(pipeline="hybrid", hybrid_rescore=False),
                     PIPELINE_STEPS, _UNFUSED),
    "hybrid_exact_remat": (dict(pipeline="hybrid", hybrid_rescore=False,
                                hybrid_checkpoint=True), PIPELINE_STEPS,
                           _UNFUSED),
    "two_pass": (dict(pipeline="two_pass"), PIPELINE_STEPS, dict(
        scatter_add=16, segment_sum_scalar=8, score_head_sampled=1,
        score_head_sampled_banded=1, score_head_bwd=1)),
}
GRAD_CHECKED = ("hybrid_rescore", "straight_through", "hybrid_exact")
# The models phase: one hybrid_rescore step (tile index, bench.py's flags)
# of every backbone x scorer pair of Scripts/run_ablation_tpu.sh. K1 and
# K2 launch per part with gradients, as (K1, K2):
#   scorers: GCN 2 layers x (K1 forward + K1 backward, K2) = (4, 2);
#     GSAGE one SAGEConv, K1 over x[senders] (f32, F=602; x has no
#     gradient, so its gather's backward does not run) and K2 over the
#     edge counts = (1, 1); MLP no graph = (0, 0).
#   backbones, each run twice (the learned and the random forward, both
#     differentiated through the gate's torch.where): GCN (4, 2); GIN
#     K1 in each layer's forward, in the backward of the second only (the
#     first gathers x) = (3, 0); GAT (heads 1) per layer K1 for the message
#     sum and its gather's backward, K2 for the softmax denominators and
#     the backward of three (N,) gathers (denominators, the source and
#     destination attention terms) = (4, 8); Cheb K=1 no graph = (0, 0).
#   plus reg2's two row gathers (K1 backward); the head is K6 over every
#   tile slot, K3 with a sorted side and K5, as in the train phase.
# So GIN + MLP and Cheb + MLP launch no K2, Cheb + MLP K1 only for reg2.
MODEL_SCORER_ROWS = {"MLP": (0, 0), "GSAGE": (1, 1), "GCN": (4, 2)}
MODEL_BACKBONE_ROWS = {"GCN": (4, 2), "GIN": (3, 0), "GAT": (4, 8),
                       "Cheb": (0, 0)}
MODEL_PAIRS = tuple((g, s) for g in MODEL_BACKBONE_ROWS
                    for s in MODEL_SCORER_ROWS)
MODEL_STEPS = 5               # timed steps of each pair
# the pairs also run graphed, profiled and grad-checked: between them
# they run every new layer and scorer but Cheb (K=1: graph-free)
MODEL_FULL = (("GAT", "GSAGE"), ("GIN", "MLP"))


def model_launches(gnn, scorer):
    """The launches of one models-phase step of the pair (see above)."""
    (s1, s2), (b1, b2) = MODEL_SCORER_ROWS[scorer], MODEL_BACKBONE_ROWS[gnn]
    out = dict(scatter_add=s1 + 2 * b1 + 2, segment_sum_scalar=s2 + 2 * b2,
               score_head_tiles=1, score_head_sampled_banded=1,
               score_head_bwd=1)
    return {k: v for k, v in out.items() if v}
# GCNConv(backend="fused"), two layers forward + backward: K2 once each, K8
# forward and dx once each
FUSED_LAUNCHES = {"segment_sum_scalar": 2, "spmm_fused": 4}
# The dense phase: dense_subgraph='on' on the bench partition (N=2048 <=
# dense_threshold) for hybrid_rescore (tile index), two_pass and the GAT
# backbone with the GCN scorer under hybrid_rescore: (train phase's
# pipeline, backbone). The random q-subgraph is densified (padding
# selections zeroed), so the scorer's encoder (every pass, two_pass's
# re-scoring pass on the winners' own (N, N) build too) and the random
# backbone forward aggregate with (N, N) products and launch no K1 or K2.
# What stays: the learned backbone's rows (MODEL_BACKBONE_ROWS) and reg2's
# two row gathers (K1 2); the head kernels as on the sparse route.
DENSE_PATHS = {"hybrid_rescore": ("hybrid_rescore", "GCN"),
               "two_pass": ("two_pass", "GCN"),
               "GAT+GCN": ("hybrid_rescore", "GAT")}


def dense_launches(pipeline, gnn):
    """The launches of one dense_subgraph='on' step (see above)."""
    b1, b2 = MODEL_BACKBONE_ROWS[gnn]
    out = {k: v for k, v in PIPELINES[pipeline][2].items()
           if k not in ("scatter_add", "segment_sum_scalar")}
    out.update(scatter_add=b1 + 2, segment_sum_scalar=b2)
    return {k: v for k, v in out.items() if v}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def build_partition(seed=0):
    """The bench partition's generator (bench.py build_partition): a
    power-law degree profile like a Reddit METIS part, as numpy arrays."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.5, N_NODES) + 1.0
    p = w / w.sum()
    senders = rng.choice(N_NODES, N_EDGES, p=p).astype(np.int32)
    receivers = rng.choice(N_NODES, N_EDGES, p=p).astype(np.int32)
    x = rng.normal(size=(N_NODES, FEAT)).astype(np.float32)
    y = rng.integers(0, CLASSES, N_NODES).astype(np.int32)
    train = rng.random(N_NODES) < 0.66
    return x, np.stack([senders, receivers]), y, train


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, funcs, iters=5):
    """The device time per call of the kernels whose names hold one of
    ``funcs`` over ``iters`` calls of ``fn`` under torch.profiler (after
    one warm-up call): (total ms, {kernel name: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, seen = {}, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            hit = next((f for f in funcs if f in e.name), None)
            if hit is not None:
                seen += 1
                by_name[hit] = by_name.get(hit, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / iters
        # every call launches at least one of ``funcs``: fewer events
        # than calls is a trace that lost records, measured again
        if seen >= iters:
            return sum(by_name.values()), by_name
        emit("profiler_retry", funcs=list(funcs), calls=iters,
             events_seen=seen, attempt=attempt + 1)
    raise SmokeFailure(f"profiler saw {seen} events of {funcs} in {iters} "
                       f"calls, {PROFILER_ATTEMPTS} times")


def timed(torch, name, fn, iters=20, warmup=3):
    """A kernel's times: CUDA events over ``iters`` back-to-back wrapper
    calls (``ms``) and its own device time from the profiler
    (``device_ms``)."""
    dev_ms, _ = device_ms(torch, fn, KERNEL_FUNCS[name])
    return dict(ms=cuda_ms(torch, fn, iters=iters, warmup=warmup),
                device_ms=dev_ms)


def sum_tolerance(abs_sum):
    # f32 sums taken in another order (atomics): the error stays far below
    # 1e-5 of the summed magnitudes; the floor covers empty rows
    return 1e-5 * abs_sum + 1e-6


@contextlib.contextmanager
def no_host_sync(torch):
    """Raise on any operation that makes the host wait for the card (a
    device-to-host read, a blocking host-to-device copy, a stream sync)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def record_row_calls():
    """Records the ids and widths of every K1 and K2 call made inside (the
    wrappers' inner functions, wrapped); ``classify_row_calls`` reads them
    after the run, so nothing inside waits for the card."""
    from sgs_gnn_tpu_torch.ops import scatter as sc
    calls = []
    saved = sc._scatter_add, sc._segment_sum_scalar

    def k1(vals, ids, n):
        calls.append(("K1", ids, vals.shape[1]))
        return saved[0](vals, ids, n)

    def k2(w, ids, n):
        calls.append(("K2", ids, 0))
        return saved[1](w, ids, n)
    sc._scatter_add, sc._segment_sum_scalar = k1, k2
    try:
        yield calls
    finally:
        sc._scatter_add, sc._segment_sum_scalar = saved


def classify_row_calls(calls):
    """{"K1 unsorted E=200000 F=256": calls, ...} of record_row_calls."""
    tally = {}
    for kernel, ids, f in calls:
        e = ids.shape[0]
        order = ("sorted" if e < 2 or bool((ids[1:] >= ids[:-1]).all())
                 else "unsorted")
        key = f"{kernel} {order} E={e}" + (f" F={f}" if f else "")
        tally[key] = tally.get(key, 0) + 1
    return dict(sorted(tally.items()))


def row_routes(launches):
    """K1's and K2's launches per route since the counters were cleared;
    each launch counted on exactly one route."""
    from sgs_gnn_tpu_torch.ops._build import ROUTES
    routes = {f"{k} {r}": v for (k, r), v in sorted(ROUTES.items())
              if k in ("scatter_add", "segment_sum_scalar")}
    for name in ("scatter_add", "segment_sum_scalar"):
        on_routes = sum(v for k, v in routes.items()
                        if k.startswith(name + " "))
        check(on_routes == launches.get(name, 0),
              f"{name}: {on_routes} launches on routes, "
              f"{launches.get(name, 0)} counted")
    return routes


def profile_breakdown(torch, fn, top=10):
    """One call of ``fn`` under torch.profiler: device time by kernel name
    (top ``top``), device busy time (union of kernel intervals) and the
    idle share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    check(bool(kernels), "profiler saw no device activity")
    by_name = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) \
            + e.time_range.elapsed_us() / 1e3
    busy, cur_s, cur_e = 0.0, None, None
    for st, en in spans:
        if cur_e is None or st > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    return dict(window_ms=window / 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / window, kernels=len(kernels),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def graph_ms(torch, fn, calls=20):
    """Device-paced time per call of ``fn``: ``calls`` calls captured in
    one CUDA graph (after a warm-up on a side stream), its replays timed by
    CUDA events, so no host work sits between the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(torch, graph.replay, iters=5, warmup=1) / calls
    del graph
    return ms


def phase_device(torch):
    card = card_line()
    print(card, flush=True)
    from sgs_gnn_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, library=lib.name)


def _ptxas_info(log_text, marker):
    """Registers, spills and stack of each kernel whose mangled name holds
    ``marker``, and ptxas' remarks on it (a serialized wgmma pipeline,
    say), from the build log's ``-Xptxas -v`` lines."""
    info, cur = {}, None
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if marker in m.group(1) else None
            if cur:
                info.setdefault(cur, {"remarks": []})
            continue
        if cur is None:
            continue
        if re.search(r"\(C\d{4}\)|[Ww]arning", line):
            info[cur]["remarks"].append(line.strip()[:300])
        m = re.search(r"Function properties for (\S+)", line)
        if m and i + 1 < len(lines):
            nums = re.findall(r"(\d+) bytes (stack frame|spill stores|"
                              r"spill loads)", lines[i + 1])
            info[cur].update({k.replace(" ", "_"): int(v) for v, k in nums})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            if sm:
                info[cur]["static_smem"] = int(sm.group(1))
    return info


def _sass_counts(lib, marker):
    """{kernel: number of HGMMA / HMMA instructions} in the SASS of the
    built library (cuobjdump -sass), for kernels whose name holds
    ``marker``; None without cuobjdump."""
    import os
    import shutil
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    counts, cur = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if marker in m.group(1) else None
            if cur:
                counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[cur][op] += 1
    return counts


def phase_sass(torch):
    """The tensor-core kernels as built (the head's forward and K5's, K8's
    tile kernel at each width): registers, spills and stack from ptxas,
    their dynamic shared memory, and the count of tensor-core instructions
    in their SASS; fails if one of them has none."""
    from sgs_gnn_tpu_torch.ops import _build, head_mma
    sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
    lib = _build.build()
    log = Path(f"{lib}.log")
    text = log.read_text() if log.exists() else ""
    smem = dict(head_mma.bwd_smem_bytes(NHID), fwd=head_mma.SMEM_BYTES,
                spmm={w: sp.tile_smem(w) for w in sp.WIDTHS})
    for marker, smem_key, want in ((HEAD_MMA_KERNEL, "fwd", 2),) + tuple(
            (k, k.split("_")[3], 1) for k in HEAD_BWD_KERNELS) + (
            ("spmm_tile_kernel", "spmm", len(sp.WIDTHS)),):
        ptxas = _ptxas_info(text, marker)
        counts = _sass_counts(lib, marker)
        emit("sass", kernels=marker, ptxas=ptxas,
             dynamic_smem_bytes=smem[smem_key],
             spill_bytes=sum(v.get("spill_stores", 0) for v in ptxas.values()),
             mma_instructions=counts, cuobjdump=counts is not None)
        check(bool(ptxas) or not log.exists(),
              f"no ptxas lines for {marker} in {log.name}")
        if counts is not None:
            check(len(counts) >= want, f"{marker}: {len(counts)} "
                  f"instantiations in the SASS ({want} expected)")
            bad = [k for k, c in counts.items()
                   if c["HGMMA"] + c["HMMA"] == 0]
            check(not bad, f"no tensor-core instructions in {bad}")


def row_cases(torch, g, gen):
    """The ids K1 and K2 get on the main paths, from the receiver-sorted
    bench partition ``g`` (degree prior): (K1 cases, K2 cases), each a list
    of (case, ids[, F]). The sampled ids are drawn as the step draws its
    prior subgraph (``sample_prior_edges``: top-k order, unsorted), which
    the scorer's encoder and the random backbone propagate over (K1
    forward over the receivers, backward over the senders); serve's draws
    are unsorted the same way. The sorted sample is the learned backbone's
    of two_pass and the exact hybrid (ascending edge ids)."""
    from sgs_gnn_tpu_torch.sparsify import sample_prior_edges
    idx = sample_prior_edges(gen, g.prob, Q, g.edge_mask).long()
    srt = idx.sort().values
    bf16, f32 = torch.bfloat16, torch.float32
    # GAT's receivers: the sampled ones with one self-loop per node appended
    looped = torch.cat([g.receivers[idx], torch.arange(
        N_NODES, dtype=torch.int32, device=g.receivers.device)])
    k1 = [("sampled receivers q=200k F=256", g.receivers[idx], NHID, bf16),
          ("sampled receivers q=200k F=41", g.receivers[idx], CLASSES, bf16),
          ("sampled senders q=200k F=256", g.senders[idx], NHID, bf16),
          ("sampled senders q=200k F=41", g.senders[idx], CLASSES, bf16),
          ("sorted receivers q=200k F=256", g.receivers[srt], NHID, bf16),
          ("receiver-sorted E=1M F=256", g.receivers, NHID, bf16),
          ("unsorted senders E=1M F=256", g.senders, NHID, bf16),
          # GIN's first layer and the GraphSAGE scorer sum raw f32 features
          ("sampled receivers q=200k F=602 f32", g.receivers[idx], FEAT,
           f32),
          # GIN's second layer and GAT's messages (E = q + N) sum f32 rows
          ("sampled receivers q=200k F=256 f32", g.receivers[idx], NHID,
           f32),
          ("sampled receivers + self-loops E=q+N F=256 f32", looped, NHID,
           f32)]
    k2 = [("receiver-sorted E=1M", g.receivers),
          ("sampled receivers q=200k", g.receivers[idx]),
          ("sorted receivers q=200k", g.receivers[srt]),
          # GAT's softmax denominators
          ("sampled receivers + self-loops E=q+N", looped)]
    return k1, k2


def time_row_kernels(torch, g, gen, funcs=None):
    """K1 and K2 on every case of ``row_cases``: error against the plain
    version, device and event times, plain and library times, bound and
    route; one ``kernel`` line each. ``funcs`` overrides the profiler's
    kernel names (tools/time_row_kernels.py times an older checkout)."""
    from sgs_gnn_tpu_torch.ops import scatter as sc
    dev = torch.device(DEVICE)
    k1_cases, k2_cases = row_cases(torch, g, gen)
    funcs = funcs or KERNEL_FUNCS

    def launch(name, fn):
        """fn() and the route its one launch of ``name`` took."""
        from sgs_gnn_tpu_torch.ops._build import ROUTES
        before = dict(ROUTES)
        res = fn()
        new = [r for (k, r), v in ROUTES.items()
               if k == name and v > before.get((k, r), 0)]
        return res, (new[0] if new else "unrouted")

    def times(name, fn):
        dev_ms, _ = device_ms(torch, fn, funcs[name], iters=10)
        return dict(ms=cuda_ms(torch, fn), device_ms=dev_ms)

    # K1's slab chunks per mode, as the kernel counted them (checkouts
    # before the count have none)
    counted = hasattr(sc, "slab_chunk_modes")
    out = {"scatter_add": [], "segment_sum_scalar": []}
    for case, ids, f, dtype in k1_cases:
        e = ids.shape[0]
        vals = torch.randn(e, f, generator=gen, device=dev).to(dtype)
        itemsize = vals.element_size()
        if counted:
            sc.reset_slab_chunk_modes()
        got, route = launch("scatter_add",
                            lambda: sc.scatter_add(vals, ids, N_NODES))
        chunks = None
        if counted and route == "slab":
            chunks = sc.slab_chunk_modes()
            rows = sc.slab_chunk_sorted(ids.cpu().numpy(), sc.scatter_plan(
                N_NODES, f, itemsize, e, sc._sm_count(ids.device.index)))
            want = {"sort": int((~rows).sum()), "rows": int(rows.sum())}
            check(chunks == want, f"scatter_add {case}: the kernel counted "
                  f"chunks {chunks}, its twin picks {want}")
        ref = sc.scatter_add_plain(vals, ids, N_NODES)
        tol = sum_tolerance(sc.scatter_add_plain(vals.abs(), ids, N_NODES))
        err = (got - ref).abs()
        check(bool((err <= tol).all()), f"scatter_add {case}: error "
              f"{float(err.max())} above tolerance")
        vals_f32, ids64 = vals.float(), ids.long()
        nbytes = e * f * itemsize + 4 * e + 4 * N_NODES * f
        row = dict(
            case=case, dtype=str(dtype).replace("torch.", ""),
            max_abs_err=float(err.max()),
            tolerance="1e-5 * sum|vals| per row + 1e-6 (f32 sums reordered "
                      "by atomics)",
            route=route, slab_chunks=chunks,
            **times("scatter_add", lambda: sc.scatter_add(vals, ids,
                                                          N_NODES)),
            plain_ms=cuda_ms(torch, lambda: sc.scatter_add_plain(
                vals, ids, N_NODES), iters=5),
            library_ms=cuda_ms(torch, lambda: torch.zeros(
                N_NODES, f, device=dev).index_add_(0, ids64, vals_f32)),
            library="index_add_ (f32 values, int64 ids)",
            bound_ms=max(nbytes / HBM_BPS, e * f / F32_FLOPS) * 1e3,
            bound_by="bytes")
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        out["scatter_add"].append(row)
        emit("kernel", name="scatter_add", **row)
    for case, ids in k2_cases:
        e = ids.shape[0]
        w = torch.rand(e, generator=gen, device=dev)
        got, route = launch("segment_sum_scalar",
                            lambda: sc.segment_sum_scalar(w, ids, N_NODES))
        ref = sc.segment_sum_scalar_plain(w, ids, N_NODES)
        err = (got - ref).abs()
        check(bool((err <= sum_tolerance(ref)).all()),
              f"segment_sum_scalar {case}: error {float(err.max())}")
        ids64 = ids.long()
        row = dict(
            case=case, max_abs_err=float(err.max()),
            tolerance="1e-5 * sum|w| per node + 1e-6 (f32 sums reordered "
                      "by atomics)",
            route=route,
            **times("segment_sum_scalar",
                    lambda: sc.segment_sum_scalar(w, ids, N_NODES)),
            plain_ms=cuda_ms(torch, lambda: sc.segment_sum_scalar_plain(
                w, ids, N_NODES), iters=5),
            library_ms=cuda_ms(torch, lambda: torch.bincount(
                ids64, weights=w, minlength=N_NODES)),
            library="bincount (int64 ids, f32 weights)",
            bound_ms=max((8 * e + 4 * N_NODES) / HBM_BPS,
                         e / F32_FLOPS) * 1e3,
            bound_by="bytes")
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        out["segment_sum_scalar"].append(row)
        emit("kernel", name="segment_sum_scalar", **row)
    return out


def phase_kernels(torch, g):
    """Each kernel against its plain version at the serving path's shapes;
    returns {kernel: {main-case numbers, cases}}."""
    from sgs_gnn_tpu_torch.ops import score_sampled as ss
    from sgs_gnn_tpu_torch.ops.dropout import HeadDropout
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(11)
    receivers, senders = g.receivers, g.senders
    results = {}

    # K1 and K2 on the ids each path feeds them; the kernels line takes the
    # case of K1's and K2's most launches: the sampled receivers
    rows = time_row_kernels(torch, g, gen)
    for name, cases in rows.items():
        main = next(c for c in cases if c["case"].startswith(
            "sampled receivers q=200k"))
        results[name] = dict(main, cases=cases)

    # K3 score_head_sampled: all E=1M edges of the partition, F=K=256 bf16
    h = torch.randn(N_NODES, NHID, generator=gen, device=dev).relu().to(
        torch.bfloat16)
    fc1 = torch.randn(2 * NHID, NHID, generator=gen, device=dev) \
        / (2 * NHID) ** 0.5
    b1 = torch.randn(NHID, generator=gen, device=dev) * 0.1
    fc2 = torch.randn(NHID, 1, generator=gen, device=dev) / NHID ** 0.5
    b2 = torch.randn(1, generator=gen, device=dev) * 0.1
    split = ss.split_head(h, fc1, b1, fc2, b2)
    q = N_EDGES
    flops = 2 * (2 * NHID * NHID) * q
    nbytes = N_NODES * NHID * 2 + 2 * NHID * NHID * 2 + 8 * NHID + 4 \
        + 8 * q + 4 * q
    # serve's scoring pass (no dropout) and two_pass's first pass (the
    # head's dropout 0.3: kernel and plain version draw the same mask)
    cases = []
    for case, rate in (("E=1M F=K=256 bf16", 0.0),
                       (f"E=1M F=K=256 bf16 dropout {DROP}", DROP)):
        drop = HeadDropout.make(rate, 4243, dev)
        kw = dict(drop_rate=rate, seed=drop.seed)
        out = ss.score_head_sampled(h, fc1, b1, fc2, b2, senders, receivers,
                                    **kw)
        ref = ss.score_head_plain(h, *split, senders, receivers, drop)
        err = float((out - ref).abs().max())
        check(err <= 1e-4, f"score_head_sampled {case}: error {err} above "
                           "1e-4")
        cases.append(dict(
            case=case, max_abs_err=err,
            tolerance="1e-4 abs on probabilities (same bf16-rounded "
                      "features and mask, f32 sums in another order)",
            **timed(torch, "score_head_sampled",
                    lambda: ss.score_head_sampled(
                        h, fc1, b1, fc2, b2, senders, receivers, **kw),
                    iters=10),
            plain_ms=cuda_ms(torch, lambda: ss.score_head_plain(
                h, *split, senders, receivers, drop), iters=10),
            library_ms=None,
            library="none: no single PyTorch call computes the head",
            bound_ms=max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3,
            bound_by="operations"))
        emit("kernel", name="score_head_sampled", **cases[-1])
    results["score_head_sampled"] = dict(cases[0], cases=cases)
    return results


def _rel_max(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _head_bwd_abs_sums(torch, ss, h, w1a, w1b, b1, w2, b2, s, r, dp, drop,
                      chunk=16384):
    """For each element of the head's VJP, the sum of the magnitudes of the
    terms summed into it (the plain backward with every factor taken by
    magnitude): the scale of a rounding or reordering in any one term."""
    from sgs_gnn_tpu_torch.ops.scatter import rows_at, scatter_add_plain
    n, f = h.shape
    k = w1a.shape[1]
    dev = h.device
    dh = torch.zeros((n, f), device=dev)
    dw1a = torch.zeros((f, k), device=dev)
    dw1b = torch.zeros((f, k), device=dev)
    db1 = torch.zeros(k, device=dev)
    dw2 = torch.zeros(k, device=dev)
    db2 = torch.zeros(1, device=dev)
    w1a_abs, w1b_abs = w1a.float().abs().t(), w1b.float().abs().t()
    for e0 in range(0, s.shape[0], chunk):
        se, re_ = s[e0:e0 + chunk], r[e0:e0 + chunk]
        hu, hv = rows_at(h, se, n), rows_at(h, re_, n)
        prod, diff, z1 = ss._first_layer(hu, hv, w1a, w1b, b1)
        zd, keep = ss._dropped(torch.relu(z1), drop, e0)
        p = torch.sigmoid(zd @ w2 + b2)
        dlogit = (dp[e0:e0 + chunk] * p * (1.0 - p)).abs()
        db2 += dlogit.sum()
        dw2 += (zd.abs() * dlogit[:, None]).sum(0)
        dz1 = dlogit[:, None] * w2.abs()
        if keep is not None:
            dz1 = torch.where(keep, dz1 * drop.scale, 0.0)
        dz1 = torch.where(z1 > 0.0, dz1, 0.0)
        db1 += dz1.sum(0)
        dw1a += prod.float().abs().t() @ dz1
        dw1b += diff.float().abs().t() @ dz1
        dprod, ddiff = dz1 @ w1a_abs, dz1 @ w1b_abs
        dh += scatter_add_plain(dprod * hv.float().abs() + ddiff, se, n)
        dh += scatter_add_plain(dprod * hu.float().abs() + ddiff, re_, n)
    return dh, dw1a, dw1b, db1, dw2, db2


def phase_head_kernels(torch, g, results):
    """K3 with dropout on the sorted sample of the tile path (both sorted
    sides), K5 on it, K6 over every tile slot: each against its plain
    version with the same mask."""
    from sgs_gnn_tpu_torch.ops import score_sampled as ss
    from sgs_gnn_tpu_torch.ops import score_tiles as st
    from sgs_gnn_tpu_torch.ops.dropout import HeadDropout
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    h = torch.randn(N_NODES, NHID, generator=gen, device=dev).relu().to(
        torch.bfloat16)
    fc1 = torch.randn(2 * NHID, NHID, generator=gen, device=dev) \
        / (2 * NHID) ** 0.5
    b1 = torch.randn(NHID, generator=gen, device=dev) * 0.1
    fc2 = torch.randn(NHID, 1, generator=gen, device=dev) / NHID ** 0.5
    b2 = torch.randn(1, generator=gen, device=dev) * 0.1
    split = ss.split_head(h, fc1, b1, fc2, b2)
    drop = HeadDropout.make(DROP, 4242, dev)
    # the tile path's sample: q valid tile slots, sorted (senders near-sorted)
    valid = torch.nonzero(g.tile_mask).flatten()
    pick = valid[torch.randperm(valid.numel(), generator=gen,
                                device=dev)[:Q]].sort().values
    aux = g.tile_aux[pick]
    s, r = aux[:, 0].contiguous(), aux[:, 1].contiguous()
    head_flops = 2 * (2 * NHID * NHID)          # per edge, forward
    head_bytes = N_NODES * NHID * 2 + 2 * NHID * NHID * 2 + 8 * NHID + 4

    # K3 with a sorted side (row 4, call_banded): the grad-enabled head's
    # forward at q=200k
    out = ss.score_head_sampled(h, fc1, b1, fc2, b2, s, r, drop_rate=DROP,
                                seed=drop.seed, sorted_side="senders")
    ref = ss.score_head_plain(h, *split, s, r, drop)
    err = float((out - ref).abs().max())
    check(err <= 1e-4, f"score_head_sampled q=200k dropout: error {err}")
    swapped = ss.score_head_sampled(h, fc1, b1, fc2, b2, s, r,
                                    drop_rate=DROP, seed=drop.seed,
                                    sorted_side="receivers")
    err_sw = float((swapped - out).abs().max())
    check(err_sw <= 1e-6, f"sorted_side=receivers changed p by {err_sw}")
    k3 = dict(case="q=200k sorted senders F=K=256 bf16 dropout 0.3",
              max_abs_err=err, receivers_side_max_abs_diff=err_sw,
              tolerance="1e-4 abs on probabilities (same bf16-rounded "
                        "features and mask, f32 sums in another order); "
                        "sorted_side=receivers within 1e-6 of senders",
              **timed(torch, "score_head_sampled_banded",
                      lambda: ss.score_head_sampled(
                          h, fc1, b1, fc2, b2, s, r, drop_rate=DROP,
                          seed=drop.seed, sorted_side="senders")),
              plain_ms=cuda_ms(torch, lambda: ss.score_head_plain(
                  h, *split, s, r, drop), iters=5),
              library_ms=None,
              library="none: no single PyTorch call computes the head",
              bound_ms=max((head_bytes + 12 * Q) / HBM_BPS,
                           head_flops * Q / BF16_FLOPS) * 1e3,
              bound_by="operations")
    emit("kernel", name="score_head_sampled_banded", **k3)
    results["score_head_sampled_banded"] = dict(k3, cases=[k3])

    # K5: its backward, with the mask regenerated from the seed; at q=200k
    # (a multiple of the kernels' edge blocks) and at q=200k-37 (a tail)
    names = ("dh", "dW1a", "dW1b", "db1", "dw2", "db2")
    dp_all = torch.randn(Q, generator=gen, device=dev)
    cases = []
    for q in (Q, Q - 37):
        sq, rq, dp = s[:q], r[:q], dp_all[:q]
        got = ss._head_bwd(h, *split, sq, rq, dp, drop)
        want = ss.score_head_bwd_plain(h, *split, sq, rq, dp, drop)

        def run(sq=sq, rq=rq, dp=dp):
            return ss._head_bwd(h, *split, sq, rq, dp, drop)
        k5_ms, k5_split = device_ms(torch, run, HEAD_BWD_KERNELS)
        scale = _head_bwd_abs_sums(torch, ss, h, *split, sq, rq, dp, drop)
        rel_max = {n: _rel_max(a, b) for n, a, b in zip(names, got, want)}
        rel_terms = {n: float(((a.float() - b.float()).abs()
                               / c.clamp(min=1e-30)).max())
                     for n, a, b, c in zip(names, got, want, scale)}
        # per element: each term passes two bf16 casts (dz1, then dh_u/dh_v
        # or the dW product); the kernel's f32 values before a cast differ
        # from the plain version's by a few f32 ulps, so a cast lands one
        # bf16 ulp (<= 2^-7 of the term) apart only for the rare terms
        # that straddle a rounding boundary: 2^-9 of the summed |terms|
        # (a term lost on a node of degree below ~500 exceeds it) + 1e-6.
        # Whole output: 1e-3 of max|plain|.
        for n, a, b, c in zip(names, got, want, scale):
            err = (a.float() - b.float()).abs()
            check(bool((err <= 2 ** -9 * c + 1e-6).all()),
                  f"score_head_bwd q={q} {n}: error above 2^-9 of the summed "
                  f"|terms| (max ratio {rel_terms[n]})")
            check(rel_max[n] <= 1e-3, f"score_head_bwd q={q} {n}: max error "
                  f"{rel_max[n]} of max|plain|, limit 1e-3")
        cases.append(dict(
            case=f"q={q} sorted senders F=K=256 bf16 dropout 0.3",
            max_abs_err=max(float((a - b).abs().max())
                            for a, b in zip(got, want)),
            max_err_over_max_ref=rel_max, max_err_over_sum_terms=rel_terms,
            tolerance="per element 2^-9 of the summed |terms| + 1e-6 (rare "
                      "one-ulp flips at the two bf16 casts), and 1e-3 of "
                      "max|plain| per output",
            ms=cuda_ms(torch, run), device_ms=k5_ms,
            device_ms_by_kernel=k5_split,
            plain_ms=cuda_ms(torch, lambda: ss.score_head_bwd_plain(
                h, *split, sq, rq, dp, drop), iters=5),
            library_ms=None,
            library="none: no single PyTorch call computes the head's VJP",
            bound_ms=max((head_bytes + 16 * q + N_NODES * NHID * 4
                          + 2 * NHID * NHID * 4) / HBM_BPS,
                         3 * head_flops * q / BF16_FLOPS) * 1e3,
            bound_by="operations"))
        emit("kernel", name="score_head_bwd", **cases[-1])
    results["score_head_bwd"] = dict(cases[0], cases=cases)

    # K6: every tile slot of the partition, tile order
    ep = g.tile_ls.shape[0]
    tile = (g.tile_ls, g.tile_lr, g.tile_su, g.tile_rv)
    kw = dict(t=g.tile_t, bk=g.tile_b, drop_rate=DROP, seed=drop.seed)
    out = st.score_head_tiles(h, fc1, b1, fc2, b2, *tile, **kw)
    ref = st.score_head_tiles_plain(h, *split, *tile, g.tile_t, g.tile_b,
                                    drop)
    err = float((out - ref).abs().max())
    check(err <= 1e-4, f"score_head_tiles: error {err} above 1e-4")
    k6 = dict(case=f"Ep={ep} (t={g.tile_t}, b={g.tile_b}) F=K=256 bf16 "
                   "dropout 0.3",
              max_abs_err=err,
              tolerance="1e-4 abs on probabilities (same bf16-rounded "
                        "features and mask, f32 sums in another order)",
              **timed(torch, "score_head_tiles",
                      lambda: st.score_head_tiles(h, fc1, b1, fc2, b2, *tile,
                                                  **kw), iters=10),
              plain_ms=cuda_ms(torch, lambda: st.score_head_tiles_plain(
                  h, *split, *tile, g.tile_t, g.tile_b, drop), iters=3,
                  warmup=1),
              library_ms=None,
              library="none: no single PyTorch call computes the head",
              bound_ms=max((head_bytes + 12 * ep + 8 * (ep // g.tile_b))
                           / HBM_BPS, head_flops * ep / BF16_FLOPS) * 1e3,
              bound_by="operations")
    emit("kernel", name="score_head_tiles", **k6)
    results["score_head_tiles"] = dict(k6, cases=[k6])


def phase_sparse_kernels(torch, g, results):
    """K7 at the unfused head's receiver-side VJP (the straight_through and
    exact hybrid paths) and K8 at the fused SpMM's shapes, each against its
    plain version."""
    from sgs_gnn_tpu_torch.ops import scatter as sc
    # the module (ops/__init__ binds the name spmm to the function)
    sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(13)
    band = g.receiver_band

    # K7: the head's (E, 256) bf16 cotangent over the receiver-sorted edges
    vals = torch.randn(N_EDGES, NHID, generator=gen, device=dev).to(
        torch.bfloat16)
    ids = g.receivers
    padded = ids.clone()           # the TPU wrapper pads with N + band
    padded[-1000:] = N_NODES
    padded[-500:] = N_NODES + band
    cases = []
    # (case, vals, ids, band, items the band rule keeps; None: fewer than E)
    for case, v, i, b, want_kept in (
            (f"E=1M F=256 bf16 receiver-sorted band={band}", vals, ids,
             band, N_EDGES),
            (f"E=1M-37 (ragged) band={band}", vals[:-37], ids[:-37], band,
             N_EDGES - 37),
            ("E=1M band=8 (undersized: items dropped)", vals, ids, 8, None),
            (f"E=1M, last 1000 ids padding (N, N+band) band={band}", vals,
             padded, band, N_EDGES - 1000)):
        e = i.shape[0]
        keep = sc.sorted_band_keep(i, N_NODES, b)
        kept = int(keep.sum())
        check(kept < e if want_kept is None else kept == want_kept,
              f"scatter_add_sorted {case}: the band rule kept {kept} of {e}")
        out = sc.scatter_add_sorted(v, i, N_NODES, b)
        ref = sc.scatter_add_sorted_plain(v, i, N_NODES, b)
        tol = sum_tolerance(sc.scatter_add_sorted_plain(v.abs(), i, N_NODES,
                                                        b))
        err = (out - ref).abs()
        check(bool((err <= tol).all()), f"scatter_add_sorted {case}: error "
              f"{float(err.max())} above tolerance")
        v32, i64 = v[keep].float(), i[keep].long()
        nbytes = e * NHID * 2 + 4 * e + 4 * N_NODES * NHID
        cases.append(dict(
            case=case, items_kept=kept, max_abs_err=float(err.max()),
            tolerance="1e-5 * sum|vals| per row + 1e-6 (f32 sums reordered "
                      "by atomics); the same items dropped",
            **timed(torch, "scatter_add_sorted",
                    lambda: sc.scatter_add_sorted(v, i, N_NODES, b)),
            plain_ms=cuda_ms(torch, lambda: sc.scatter_add_sorted_plain(
                v, i, N_NODES, b), iters=5),
            library_ms=cuda_ms(torch, lambda: torch.zeros(
                N_NODES, NHID, device=dev).index_add_(0, i64, v32)),
            library="index_add_ of the kept items (f32, int64 ids)",
            bound_ms=max(nbytes / HBM_BPS, e * NHID / F32_FLOPS) * 1e3,
            bound_by="bytes"))
        emit("kernel", name="scatter_add_sorted", **cases[-1])
    results["scatter_add_sorted"] = dict(cases[0], cases=cases)

    # K8: the whole receiver-sorted edge list and its reversal (the
    # backward's, receivers unsorted), F = nhid and classes, bf16 (the tile
    # route), and f32 (the gather route, by dtype). The library's yardstick
    # does the same work: torch.sparse.mm of a CSR that holds K8's E
    # nonzeros as they are (duplicate (receiver, sender) pairs kept;
    # weights rounded to x's type, as K8 rounds them), built outside the
    # timed region
    def csr(s, r, w, dtype):
        order = torch.argsort(r, stable=True)
        crow = torch.zeros(N_NODES + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(r.long(), minlength=N_NODES),
                                0)
        return torch.sparse_csr_tensor(
            crow, s.long()[order], w.to(dtype).float()[order],
            (N_NODES, N_NODES))

    cases = []
    sorted_ms = {}
    for f, dtype in ((NHID, torch.bfloat16), (CLASSES, torch.bfloat16),
                     (NHID, torch.float32)):
        x = torch.randn(N_NODES, f, generator=gen, device=dev).to(dtype)
        xf = x.float()
        for weighted in (False, True):
            if dtype == torch.float32 and weighted:
                continue
            w = (torch.rand(N_EDGES, generator=gen, device=dev) if weighted
                 else torch.ones(N_EDGES, device=dev))
            for order, s, r in (("receiver-sorted", g.senders, g.receivers),
                                ("reversed", g.receivers, g.senders)):
                if dtype == torch.float32 and order == "reversed":
                    continue
                kind = "weighted" if weighted else "unweighted"
                name = "bf16" if dtype == torch.bfloat16 else "f32"
                case = f"E=1M F={f} {name} {kind} {order}"
                k8 = _spmm_case(torch, sp, s, r, w, x, case)
                a_w = csr(s, r, w, x.dtype)
                lib_err = float((torch.sparse.mm(a_w, xf)
                                 - sp.spmm_fused_plain(s, r, w, x, N_NODES))
                                .abs().max())
                w_auto = w if weighted else None
                cases.append(dict(
                    case=case, **k8,
                    plain_ms=cuda_ms(torch, lambda: sp.spmm_fused_plain(
                        s, r, w, x, N_NODES), iters=5),
                    library_ms=cuda_ms(torch, lambda: torch.sparse.mm(a_w,
                                                                      xf)),
                    library_device_ms=device_ms(
                        torch, lambda: torch.sparse.mm(a_w, xf), ("",))[0],
                    library="torch.sparse.mm of A_w as CSR (f32) with K8's "
                            "E nonzeros (duplicates kept) by x (f32)",
                    library_max_abs_err=lib_err,
                    auto_route_ms=cuda_ms(torch, lambda: sp.spmm(
                        s, r, w_auto, x, N_NODES))))
                k = cases[-1]
                k["faster_than_library"] = \
                    k["device_ms"] < k["library_device_ms"]
                if order == "receiver-sorted":
                    sorted_ms[f, name, kind] = k["device_ms"]
                else:
                    k["over_sorted"] = k["device_ms"] / sorted_ms[f, name,
                                                                  kind]
                if f == NHID and not weighted and name == "bf16" \
                        and order == "receiver-sorted":
                    k["coalesced"] = _spmm_coalesced(torch, sp, s, r, w, x,
                                                     csr)
                if name == "bf16":
                    check(k["route"] == "tiles", f"spmm_fused {case}: route "
                          f"{k['route']}, expected tiles")
                else:
                    check(k["route"] == "gather", f"spmm_fused {case}: "
                          f"route {k['route']}, expected gather (f32)")
                emit("kernel", name="spmm_fused", **k)
    # the main case: the scorer layer's forward (F = nhid, unweighted)
    results["spmm_fused"] = dict(cases[0], cases=cases)


def _spmm_case(torch, sp, s, r, w, x, case):
    """One K8 case: its route (counted by the wrapper), the error against
    the plain version (checked), CUDA-event and profiler times, the
    binning's own device time, and the bound: on the tile route the bytes
    12E + N*F*(itemsize + 4) at 3.35 TB/s (the 2EF tensor-core operations
    take less), on the gather route 2EF f32 operations at 67 TFLOP/s; the
    f32-operations count for every route beside it, for comparison with
    the gather kernel's bound."""
    from sgs_gnn_tpu_torch.ops._build import ROUTES
    before = dict(ROUTES)
    out = sp._spmm_fused(s, r, w, x, N_NODES)
    route = next(rt for (kn, rt), v in ROUTES.items()
                 if kn == "spmm_fused" and v > before.get((kn, rt), 0))
    ref = sp.spmm_fused_plain(s, r, w, x, N_NODES)
    tol = sum_tolerance(sp.spmm_fused_plain(s, r, w, x.abs(), N_NODES))
    err = (out - ref).abs()
    check(bool((err <= tol).all()), f"spmm_fused {case}: error "
          f"{float(err.max())} above tolerance")
    e, f = s.shape[0], x.shape[1]
    dev_ms, by_name = device_ms(torch, lambda: sp._spmm_fused(
        s, r, w, x, N_NODES), KERNEL_FUNCS["spmm_fused"])
    nbytes = 12 * e + N_NODES * f * (x.element_size() + 4)
    old_bound = 2 * e * f / F32_FLOPS * 1e3
    if route == "tiles":
        bound = max(nbytes / HBM_BPS, 2 * e * f / BF16_FLOPS) * 1e3
        bound_by = "bytes"
    else:
        bound = max(nbytes / HBM_BPS * 1e3, old_bound)
        bound_by = "operations"
    return dict(
        route=route, max_abs_err=float(err.max()),
        tolerance="1e-5 * sum|w x| per row + 1e-6 (f32 sums reordered; "
                  "the tile route's hi + lo weights within 2^-17)",
        ms=cuda_ms(torch, lambda: sp._spmm_fused(s, r, w, x, N_NODES)),
        device_ms=dev_ms, device_ms_by_kernel=by_name,
        binning_device_ms=sum(v for k, v in by_name.items()
                              if k in SPMM_BIN_FUNCS),
        bound_ms=bound, bound_by=bound_by,
        bound_ms_f32_operations=old_bound)


def _spmm_coalesced(torch, sp, s, r, w, x, csr):
    """K8 and torch.sparse.mm on the coalesced edge list: one nonzero per
    distinct (receiver, sender) pair with the pair's weights summed."""
    key = r.long() * N_NODES + s.long()
    pairs, inv = torch.unique(key, return_inverse=True)
    wu = torch.zeros(pairs.shape[0], device=w.device).index_add_(0, inv, w)
    ru = (pairs // N_NODES).int()
    su = (pairs % N_NODES).int()
    k8 = _spmm_case(torch, sp, su, ru, wu, x, "coalesced")
    a_u = csr(su, ru, wu, x.dtype)
    xf = x.float()
    k8.update(pairs=int(pairs.shape[0]),
              library_ms=cuda_ms(torch, lambda: torch.sparse.mm(a_u, xf)),
              library_device_ms=device_ms(
                  torch, lambda: torch.sparse.mm(a_u, xf), ("",))[0])
    k8["faster_than_library"] = k8["device_ms"] < k8["library_device_ms"]
    return k8


def phase_serve(torch, arrays):
    from sgs_gnn_tpu_torch import (Config, Graph, get_model, make_predictor,
                                   make_sparsifier)
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.ops import scatter as sc
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES, ROUTES
    x, edge_index, y, train = arrays
    prob = degree_prior(edge_index[0], edge_index[1], N_NODES)
    build_kw = dict(prob=prob, num_classes=CLASSES, sort_by_receiver=True)
    cfg = Config(nhid=NHID, dtype="bfloat16", num_samples_eval=DRAWS)
    g = Graph.build(x, edge_index, y, train, ~train, None, device=DEVICE,
                    **build_kw)
    model = get_model("GCN", FEAT, NHID, CLASSES, cfg.drop_rate, "GCN",
                      dtype=cfg.dtype, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    sparsify = make_sparsifier(cfg, model, Q)
    predict = make_predictor(cfg, model, Q)
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    # the main path, once, with every launch counter at 0 just before it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTES.clear()
    sc.reset_slab_chunk_modes()
    t0 = time.perf_counter()
    with no_host_sync(torch):
        sp = sparsify(g, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with no_host_sync(torch):
        logits, labels = predict(g, gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    routes = row_routes(launches)
    peak = torch.cuda.max_memory_allocated()
    slab_chunks = sc.slab_chunk_modes()
    # the id case of each K1 and K2 call, from a second run with the same
    # draws: the recorder holds every call's ids, so it stays out of the
    # measured run's memory and times
    # (eagerly: a graph's replay calls no wrapper)
    eager_sparsify, eager_predict = sparsify.eager, predict.eager
    again = torch.Generator(device=DEVICE).manual_seed(1)
    with record_row_calls() as calls:
        eager_sparsify(g, again)
        eager_predict(g, again)
    row_calls = classify_row_calls(calls)
    del calls

    expect = {"scatter_add": 2 + 2 + 2 * DRAWS,
              "segment_sum_scalar": 2 + 2 + 2 * DRAWS,
              "score_head_sampled": 2}
    check(launches == expect, f"launch counts {launches}, expected {expect}")
    check(sp.probs.shape == (N_EDGES,) and sp.probs.dtype == torch.float32,
          f"probs {tuple(sp.probs.shape)} {sp.probs.dtype}")
    check(bool(torch.isfinite(sp.probs).all())
          and bool(((sp.probs >= 0) & (sp.probs <= 1)).all()),
          "probs not finite probabilities")
    check(sp.edge_ids.shape == (Q,)
          and int(torch.unique(sp.edge_ids).numel()) == Q,
          "edge_ids not q distinct edges")
    check(torch.equal(sp.weights, sp.probs[sp.edge_ids]),
          "weights != probs[edge_ids]")
    check(torch.equal(sp.receivers, g.receivers[sp.edge_ids]),
          "receivers != graph receivers[edge_ids]")
    check(logits.shape == (N_NODES, CLASSES)
          and bool(torch.isfinite(logits).all()), "logits not finite")
    check(int(labels.min()) >= 0 and int(labels.max()) < CLASSES,
          "labels out of range")

    # steady-state times (kernels built, caches warm, graphs captured):
    # the graphed calls (the default on the card) and the eager ones in
    # turns, graphed / eager / eager / graphed, 3 calls per block
    reps = 3
    blocks = {}

    def block(label, fn):
        t = time.perf_counter()
        for _ in range(reps):
            fn(g, gen)
        torch.cuda.synchronize()
        blocks.setdefault(label, []).append(
            (time.perf_counter() - t) / reps * 1e3)
    for name, graphed_fn, eager_fn in (
            ("sparsify", sparsify, eager_sparsify),
            ("predict", predict, eager_predict)):
        block(name, graphed_fn)
        block(name + "_eager", eager_fn)
        block(name + "_eager", eager_fn)
        block(name, graphed_fn)
    ms = {k: float(np.mean(v)) for k, v in blocks.items()}
    sparsify_ms, predict_ms = ms["sparsify"], ms["predict"]
    check(len(sparsify.graphs) == 1 and len(predict.graphs) == 1,
          f"serve graphs: {len(sparsify.graphs)} / {len(predict.graphs)}")

    # graphed against eager from the same seed, a new generator per call
    # as a server that makes one per request: the graphed calls replay the
    # graphs captured above (one replay each, no new graph)
    replays0 = (sparsify.graphs.replays, predict.graphs.replays)
    sp_e = eager_sparsify(g, torch.Generator(device=DEVICE).manual_seed(9))
    sp_g = sparsify(g, torch.Generator(device=DEVICE).manual_seed(9))
    overlap = int(np.intersect1d(sp_e.edge_ids.cpu().numpy(),
                                 sp_g.edge_ids.cpu().numpy()).size) / Q
    lg_e, _ = eager_predict(g, torch.Generator(device=DEVICE).manual_seed(9))
    lg_g, _ = predict(g, torch.Generator(device=DEVICE).manual_seed(9))
    graphed_err = float((lg_g - lg_e).abs().max())
    lg_scale = float(lg_e.abs().max())
    check(len(sparsify.graphs) == 1 and len(predict.graphs) == 1
          and (sparsify.graphs.replays, predict.graphs.replays)
          == (replays0[0] + 1, replays0[1] + 1),
          f"graphed vs eager: the graphed calls did not replay "
          f"({len(sparsify.graphs)} / {len(predict.graphs)} graphs, "
          f"replays {replays0} -> {sparsify.graphs.replays} / "
          f"{predict.graphs.replays})")
    # the same draws but for keys within f32 reordering of each other
    # (the encoder's K1 atomics): nearly every edge is shared and the
    # logits agree to bf16 rounding
    check(overlap >= 0.999, f"graphed sparsify shares {overlap} of its "
                            "edges with the eager one (limit 0.999)")
    check(graphed_err <= 1e-2 * max(lg_scale, 1.0),
          f"graphed predict vs eager: max {graphed_err} (limit 1% of "
          f"max |logit| {lg_scale})")

    for call, fn in (("sparsify", lambda: sparsify(g, gen)),
                     ("predict", lambda: predict(g, gen)),
                     ("predict eager", lambda: eager_predict(g, gen))):
        emit("profile", call=call, **profile_breakdown(torch, fn))

    # the same port on the CPU in f32 (plain versions), same weights
    t = time.perf_counter()
    g_cpu = Graph.build(x, edge_index, y, train, ~train, None, device="cpu",
                        **build_kw)
    model_cpu = get_model("GCN", FEAT, NHID, CLASSES, cfg.drop_rate, "GCN",
                          dtype="float32", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    sub = np.random.default_rng(2).choice(N_EDGES, CPU_SUBSAMPLE,
                                          replace=False)
    sub_t = torch.from_numpy(sub)
    with torch.no_grad():
        h_cpu = model_cpu.edge_prob_mlp.encode(g_cpu.x, g_cpu.senders,
                                               g_cpu.receivers)
        p_cpu = model_cpu.edge_prob_mlp.score_from(
            h_cpu, g_cpu.senders[sub_t], g_cpu.receivers[sub_t])
        idx = sp.edge_ids.cpu()
        logits_cpu = model_cpu(g_cpu.x, g_cpu.senders[idx],
                               g_cpu.receivers[idx], sp.weights.cpu())
        logits_draw = model(g.x, sp.senders, sp.receivers, sp.weights).cpu()
    cpu_s = time.perf_counter() - t
    p_err = (sp.probs.cpu()[sub_t] - p_cpu).abs()
    l_err = (logits_draw - logits_cpu).abs()
    l_scale = float(logits_cpu.abs().max())
    emit("serve", nodes=N_NODES, edges=N_EDGES, features=FEAT, nhid=NHID,
         classes=CLASSES, q=Q, draws=DRAWS, dtype=cfg.dtype,
         receiver_band=g.receiver_band,
         first_sparsify_ms=(t1 - t0) * 1e3, first_predict_ms=(t2 - t1) * 1e3,
         sparsify_ms=sparsify_ms, edges_per_s=N_EDGES / sparsify_ms * 1e3,
         predict_ms=predict_ms, eager_sparsify_ms=ms["sparsify_eager"],
         eager_predict_ms=ms["predict_eager"], block_ms=blocks,
         graphed_edge_overlap=overlap, graphed_logits_max_abs_err=graphed_err,
         max_memory_allocated=peak, launches=launches,
         row_routes=routes, row_calls=row_calls,
         k1_slab_chunks=slab_chunks, cpu_reference_s=cpu_s, cpu_subsample=CPU_SUBSAMPLE,
         probs_max_abs_err=float(p_err.max()),
         probs_mean_abs_err=float(p_err.mean()),
         logits_max_abs_err=float(l_err.max()), logits_max_abs=l_scale)
    # bf16 card run against the f32 CPU run: bf16 rounds inputs, weights and
    # every projection to 8 significant bits (relative 2^-9 per rounding),
    # compounded over 2 GCN layers and the head
    # (the same comparison on the CPU at E=100k gave a probs error of 6e-4
    # max, 6e-5 mean, and a logits error of 0.4% of the largest logit)
    check(float(p_err.max()) <= 1e-2 and float(p_err.mean()) <= 1e-3,
          f"probs: card bf16 vs CPU f32 max {float(p_err.max())}, mean "
          f"{float(p_err.mean())} (limits 1e-2, 1e-3)")
    check(float(l_err.max()) <= 0.02 * max(l_scale, 1.0),
          f"backbone logits on the sparsified draw: card bf16 vs CPU f32 "
          f"max {float(l_err.max())} (limit 2% of max |logit| {l_scale})")
    return launches


def phase_fused_spmm(torch, g):
    """GCNConv(backend="fused") forward + backward at the scorer's first
    layer (602 -> 256 over all E=1M edges, unweighted) and the backbone's
    second (256 -> 41 over q=200k sampled edges, weighted), launch-counted,
    then the same layers with backend="auto": outputs and gradients
    compared. Returns the fused run's launches."""
    from sgs_gnn_tpu_torch.models.layers import GCNConv
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES, ROUTES
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(14)
    sub = torch.randperm(N_EDGES, generator=gen, device=dev)[:Q].sort().values
    h = torch.randn(N_NODES, NHID, generator=gen, device=dev).relu()
    w = torch.rand(Q, generator=gen, device=dev)
    layers, inputs, cots = [], [], []
    for k, (fin, fout, s, r, x, wt) in enumerate((
            (FEAT, NHID, g.senders, g.receivers, g.x, None),
            (NHID, CLASSES, g.senders[sub], g.receivers[sub], h, w))):
        layers.append(GCNConv(fin, fout, torch.bfloat16,
                              torch.Generator().manual_seed(20 + k),
                              backend="fused").to(dev))
        inputs.append((x if wt is None else x.clone().requires_grad_(), s, r,
                       None if wt is None else wt.clone().requires_grad_()))
        cots.append(torch.randn(N_NODES, fout, generator=gen, device=dev))

    def run():
        res = []
        for layer, (x, s, r, wt), cot in zip(layers, inputs, cots):
            out = layer(x, s, r, wt)
            wrt = [t for t in (x, wt) if t is not None and t.requires_grad]
            wrt += list(layer.parameters())
            res.append([out.detach()] + list(torch.autograd.grad(
                out, wrt, cot)))
        return res

    torch.cuda.synchronize()
    LAUNCHES.clear()
    ROUTES.clear()
    with no_host_sync(torch):
        fused = run()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    routes = {f"{k} {r}": v for (k, r), v in ROUTES.items()
              if k == "spmm_fused"}
    check(launches == FUSED_LAUNCHES,
          f"fused SpMM launch counts {launches}, expected {FUSED_LAUNCHES}")
    # both layers' forward and dx on the tile route (E=1M and q=200k over
    # 1024 tiles: 977 and 195 edges a tile)
    check(routes == {"spmm_fused tiles": FUSED_LAUNCHES["spmm_fused"]},
          f"fused SpMM routes {routes}")
    fused_ms = cuda_ms(torch, run, iters=5, warmup=1)
    for layer in layers:
        layer.backend = "auto"
    auto = run()
    auto_ms = cuda_ms(torch, run, iters=5, warmup=1)
    names = (["out", "dW", "db"], ["out", "dx", "dw", "dW", "db"])
    rel = [{n: float((a.float() - b.float()).norm()
                     / b.float().norm().clamp(min=1e-30))
            for n, a, b in zip(ns, fa, aa)}
           for ns, fa, aa in zip(names, fused, auto)]
    emit("fused_spmm", cases=["scorer gcn1 602->256 E=1M unweighted",
                              "backbone gcn2 256->41 q=200k weighted"],
         launches=launches, routes=routes, rel_l2_fused_vs_auto=rel,
         tolerance=f"relative L2 {FUSED_REL_TOL} per tensor (bf16: the auto "
                   "route rounds each product w*x to bf16, K8 keeps f32)",
         fused_fwd_bwd_ms=fused_ms, auto_fwd_bwd_ms=auto_ms)
    bad = [(i, n, e) for i, r_ in enumerate(rel) for n, e in r_.items()
           if not e <= FUSED_REL_TOL]
    check(not bad, f"GCNConv fused vs auto: {bad}")
    return launches


def _frozen_sampling(torch, pipelines, idx, rand_idx):
    """Replace the training step's samplers with fixed indices and the
    weight formulas of ``sample_edges`` (straight-through weights keep
    their gradient path), as the parity tests freeze them; returns a
    function that restores them."""
    from sgs_gnn_tpu_torch.sparsify.sampling import _normalized
    saved = pipelines.sample_edges, pipelines.sample_prior_edges

    def sample_edges(generator, edge_probs, prior, q, beta, istest=False,
                     edge_mask=None):
        i = idx.to(edge_probs.device)
        samples = _normalized(edge_probs, edge_mask)
        if not istest:
            prior_ = (prior if edge_mask is None
                      else torch.where(edge_mask, prior, 0.0))
            samples = (1.0 - beta) * samples + beta * prior_
        sel = samples[i.long()]
        st = (1.0 - sel).detach() + sel
        return i, torch.clamp(edge_probs[i.long()] * st, 0.0, 1.0)

    pipelines.sample_edges = sample_edges
    pipelines.sample_prior_edges = \
        lambda generator, prior, q, edge_mask=None: rand_idx.to(prior.device)

    def restore():
        pipelines.sample_edges, pipelines.sample_prior_edges = saved
    return restore


def _grad_check(torch, arrays, g_card, name, cfg_kw, derived=False):
    """One frozen-sample step without dropout: loss and per-parameter
    gradients on the card (bf16, kernels) against the port on the CPU
    (f32, plain versions), same weights; limits 1% on the loss and
    GRAD_REL_TOL (relative L2) on each gradient.

    ``derived`` (the models phase) adds a third run, the same step on the
    CPU in bf16: the card's roundings (inputs, weights, every projection
    and the head's features to 8 significant bits) without its kernels.
    Each gradient's limit is then the larger of GRAD_REL_TOL and twice
    that run's own error against f32 (the card's sums in another order, as
    much again). Where a gradient sums terms that cancel, a bf16 rounding
    comes back amplified: GAT's attention vectors (the softmax Jacobian
    sums to zero over a node's edges; only the leaky_relu slopes keep the
    terms apart), and the first projection of the MLP and GraphSAGE
    scorers, whose weight gradient is the head's dh against the raw
    features, with no aggregation between them to average dh's rounding
    out (on an H100 at full width the GraphSAGE scorer's lin_r gradient
    came out 6.0% off the f32 one)."""
    from sgs_gnn_tpu_torch import Config, Graph, get_model
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.train import pipelines
    x, edge_index, y, train = arrays
    cfg = Config(**dict(cfg_kw, drop_rate=0.0, conditional=False))
    # hybrid_rescore samples in tile space
    tiles = cfg.pipeline == "hybrid" and cfg.hybrid_rescore
    rng = np.random.default_rng(3)
    valid = np.flatnonzero((g_card.tile_mask if tiles else g_card.edge_mask)
                           .cpu().numpy())
    idx = torch.from_numpy(np.sort(rng.choice(valid, Q, replace=False))
                           .astype(np.int32))
    rand_idx = torch.from_numpy(rng.choice(N_EDGES, Q, replace=False)
                                .astype(np.int32))
    restore = _frozen_sampling(torch, pipelines, idx, rand_idx)
    runs = [("card", DEVICE, g_card, "bfloat16"), ("cpu", "cpu", None,
                                                   "float32")]
    if derived:
        runs.append(("cpu_bf16", "cpu", None, "bfloat16"))
    try:
        out, g_cpu = {}, None
        t0 = time.perf_counter()
        for run, dev, g, dtype in runs:
            if g is None:
                if g_cpu is None:
                    g_cpu = Graph.build(
                        x, edge_index, y, train, ~train, None,
                        prob=degree_prior(edge_index[0], edge_index[1],
                                          N_NODES),
                        num_classes=CLASSES, sort_by_receiver=True,
                        tile_index=tiles, device="cpu")
                g = g_cpu
            model = get_model(cfg.GNN, FEAT, NHID, CLASSES, 0.0,
                              cfg.edge_mlp_type, heads=cfg.gat_heads,
                              dtype=dtype, device=dev,
                              generator=torch.Generator().manual_seed(5))
            loss, _ = pipelines.make_learned_loss(cfg, model, Q)(
                g, torch.Generator(device=dev).manual_seed(0))
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            out[run] = (float(loss.detach()),
                        {n: gr.float().cpu() for n, gr in zip(names, grads)})
        cpu_s = time.perf_counter() - t0
    finally:
        restore()

    def rel_l2(a, b):
        return {n: _rel_l2(a[n], b[n]) for n in b}

    (loss_c, g_c), (loss_f, g_f) = out["card"], out["cpu"]
    rel = rel_l2(g_c, g_f)
    limits = {n: GRAD_REL_TOL for n in g_f}
    bf16_rel = None
    if derived:
        bf16_rel = rel_l2(out["cpu_bf16"][1], g_f)
        limits = {n: max(GRAD_REL_TOL, 2.0 * bf16_rel[n]) for n in g_f}
    loss_rel = abs(loss_c - loss_f) / abs(loss_f)
    emit("grad_check", pipeline=name, edges=N_EDGES, q=Q,
         loss_card_bf16=loss_c, loss_cpu_f32=loss_f, loss_rel_err=loss_rel,
         grad_rel_l2_err=rel, seconds=cpu_s,
         cpu_bf16_rel_l2_err=bf16_rel,
         loss_cpu_bf16=out["cpu_bf16"][0] if derived else None,
         limits={n: v for n, v in limits.items() if v != GRAD_REL_TOL},
         note="sample frozen (straight-through weight formula), dropout "
              "off, conditional off (every parameter gets a gradient)")
    # bf16 rounds inputs, weights, the head's features and casts and every
    # projection to 8 significant bits; over the encoder, the head's
    # backward (dz1, dh_u/dh_v, dW1a/dW1b cast to bf16) and two GCN layers
    # that leaves ~1e-2 relative on gradients
    check(loss_rel <= 1e-2, f"grad_check: loss card {loss_c} vs cpu "
                            f"{loss_f} (limit 1% relative)")
    bad = {n: (e, limits[n]) for n, e in rel.items() if not e <= limits[n]}
    check(not bad, f"grad_check: gradients off by more than their limits "
                   f"(relative L2; error, limit): {bad}")


def _train_path(torch, g, name, cfg_kw, steps, expect, phase="train",
                full=True):
    """One pipeline's (or backbone x scorer pair's) training at full width:
    a warm-up step, one launch-counted step under no_host_sync, ``steps``
    timed steps, one profiled step, a ``phase`` line; with ``full`` also
    the graphed step and a ``profile`` line per route (else the ``phase``
    line carries the eager step's device busy time and idle share);
    returns the counted step's launches. Every parameter must move; in
    the models phase the scorer's may stay where no step's conditional
    gate passed (the loss is then the random subgraph's, which the scorer
    does not reach)."""
    from sgs_gnn_tpu_torch import (Config, DualOptimizer, get_model,
                                   make_train_step)
    from sgs_gnn_tpu_torch.ops import scatter as sc
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES, ROUTES
    cfg = Config(**cfg_kw)
    check(cfg.drop_rate == DROP, f"drop_rate {cfg.drop_rate}")
    model = get_model(cfg.GNN, FEAT, NHID, CLASSES, cfg.drop_rate,
                      cfg.edge_mlp_type, heads=cfg.gat_heads,
                      dtype=cfg.dtype, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
    step = make_train_step(cfg, model, opt, Q, max_epoch=steps + 2)
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    t0 = time.perf_counter()
    m = step(g, 0, gen)                       # warm-up
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(m.loss)), f"{name}: warm-up loss "
                                        f"{float(m.loss)}")
    gates_all = [m.conditional_update]

    # the main path, one step, with every launch counter at 0 just before
    # it; any wait of the host for the card inside the step raises
    torch.cuda.synchronize()
    LAUNCHES.clear()
    ROUTES.clear()
    sc.reset_slab_chunk_modes()
    with record_row_calls() as calls, no_host_sync(torch):
        m = step(g, 1, gen)
    torch.cuda.synchronize()
    gates_all.append(m.conditional_update)
    launches = dict(LAUNCHES)
    routes = row_routes(launches)
    slab_chunks = sc.slab_chunk_modes()
    row_calls = classify_row_calls(calls)
    del calls
    check(launches == expect,
          f"{name}: launch counts {launches}, expected {expect}")

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    t0 = time.perf_counter()
    for i in range(steps):
        metrics.append(step(g, 2 + i, gen))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack([mt.loss for mt in metrics]).cpu()
    gates = torch.stack([mt.conditional_update for mt in metrics]).cpu()
    check(bool(torch.isfinite(losses).all()),
          f"{name}: losses {losses.tolist()}")
    still = [n for (n, p), b in zip(model.named_parameters(), before)
             if torch.equal(p.detach(), b)]
    gated = phase in ("model", "dense") and not bool(torch.cat(
        [torch.stack(gates_all).cpu(), gates]).any())
    check(not still or (gated and all(n.startswith("edge_prob_mlp.")
                                      for n in still)),
          f"{name}: parameters that did not move: {still}")
    extra = {}
    if cfg.pipeline == "hybrid" and cfg.hybrid_rescore:
        extra = dict(tile_slots=g.tile_ls.shape[0],
                     hybrid_train_edges_per_s=N_EDGES / step_ms * 1e3)
    eager_profile = profile_breakdown(torch, lambda: step(g, steps + 2, gen))
    if phase == "model":
        extra.update(parameters_not_moved=still,
                     device_busy_ms=eager_profile["device_busy_ms"],
                     idle_share=eager_profile["idle_share"])
    graphed = None
    if full:
        graphed = _graphed_train_path(torch, g, name, cfg, model, opt, steps,
                                      expect)
    emit(phase, pipeline=name, config=cfg_kw, nodes=N_NODES,
         edges=N_EDGES, features=FEAT, nhid=NHID, classes=CLASSES, q=Q,
         dtype=cfg.dtype, drop_rate=cfg.drop_rate, steps=steps,
         first_step_ms=first_ms, step_ms=step_ms,
         train_edges_per_s=N_EDGES / step_ms * 1e3,
         max_memory_allocated=peak, memory_allocated_before=base,
         losses=losses.tolist(), gates=gates.tolist(),
         launches_per_step=launches, row_routes_per_step=routes,
         row_calls_per_step=row_calls,
         k1_slab_chunks_per_step=slab_chunks, graphed=graphed, **extra)
    if full:
        emit("profile", call=f"train_step {name}", **eager_profile)
    return launches


def _graphed_train_path(torch, g, name, cfg, model, opt, steps, expect):
    """The same pipeline's step as a CUDA graph (make_scan_epoch_step over
    this one batch, the sampled case): the first call runs eagerly and
    captures; one launch-counted replay under no_host_sync, held to the
    eager step's counts; ``steps`` timed replays (host clock, each with
    the reseed and the copy into the class's buffers); the memory the
    graph holds (buffers and pool, from memory_reserved); one replay under
    torch.profiler."""
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    from sgs_gnn_tpu_torch.run.driver import batch_seed
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    epoch_step = make_scan_epoch_step(cfg, model, opt, Q, steps + 4, 1)
    gen = torch.Generator(device=DEVICE)

    def one(epoch):
        return epoch_step([g], [0], [2], epoch, gen,
                          lambda n: batch_seed(0, 0, n))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    one(0)                                        # eager step, capture
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    graph_bytes = torch.cuda.memory_reserved() - reserved0
    LAUNCHES.clear()
    with no_host_sync(torch):
        one(1)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    check(launches == expect, f"{name} graphed: launch counts {launches}, "
                              f"expected {expect}")
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(one(2 + i)[0].clone())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()),
          f"{name} graphed: losses {losses.tolist()}")
    check(len(epoch_step.graphs) == 1
          and epoch_step.graphs.replays == steps + 1,
          f"{name} graphed: {len(epoch_step.graphs)} graphs, "
          f"{epoch_step.graphs.replays} replays")
    prof = profile_breakdown(torch, lambda: one(steps + 2))
    emit("profile", call=f"train_step {name} graphed", **prof)
    del epoch_step
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, capture_step_ms=capture_ms,
                train_edges_per_s=N_EDGES / step_ms * 1e3,
                graph_reserved_bytes=graph_bytes,
                launches_per_replay=launches, losses=losses.tolist(),
                device_busy_ms=prof["device_busy_ms"],
                idle_share=prof["idle_share"])


def train_graph(torch, arrays):
    """The bench partition on the card, receiver-sorted, with the degree
    prior and its tile index (only hybrid_rescore reads it)."""
    from sgs_gnn_tpu_torch import Graph
    from sgs_gnn_tpu_torch.data import degree_prior
    x, edge_index, y, train = arrays
    g = Graph.build(x, edge_index, y, train, ~train, None, device=DEVICE,
                    prob=degree_prior(edge_index[0], edge_index[1], N_NODES),
                    num_classes=CLASSES, sort_by_receiver=True,
                    tile_index=True)
    check(g.tile_t == 128 and g.tile_b == 512, "no tile index")
    check(g.receiver_band > 0, "the edge list is not receiver-sorted")
    return g


def bench_config(**overrides):
    """bench.py's learned configuration (drop_rate keeps its default,
    0.3) at the partition's widths, bf16."""
    return dict(mode="learned", conditional=True, sparse_edge_mlp=True,
                reg1=True, reg2=True, nhid=NHID, dtype="bfloat16",
                **overrides)


def phase_train(torch, arrays, g):
    """Every learned pipeline (GCN + GCN scorer) on the bench partition
    ``g`` (``train_graph``); returns {pipeline: launches}."""
    launches, cfgs = {}, {}
    for name, (overrides, steps, expect) in PIPELINES.items():
        cfgs[name] = bench_config(**overrides)
        launches[name] = _train_path(torch, g, name, cfgs[name], steps,
                                     expect)
        torch.cuda.empty_cache()
    # after every timed path: the grad checks' f32 runs on the CPU slowed
    # the host's launches of a path timed right after them
    for name in GRAD_CHECKED:
        _grad_check(torch, arrays, g, name, cfgs[name])
        torch.cuda.empty_cache()
    return launches


def phase_models(torch, arrays, g):
    """One hybrid_rescore step (tile index) of every backbone x scorer pair
    on the bench partition ``g``: a warm-up step, one launch-counted step
    under no_host_sync held to ``model_launches``, MODEL_STEPS timed steps
    (finite losses, parameters moved, peak memory) and a ``model`` line
    each; the MODEL_FULL pairs also graphed (make_scan_epoch_step, the
    eager step's launch counts) with a ``profile`` line for each route,
    then, after every timed pair, a ``grad_check`` (frozen sample, no
    dropout, card bf16 against the port on the CPU in f32; the loss within
    1%, each gradient within the larger of GRAD_REL_TOL and twice the same
    step's error on the CPU in bf16, ``_grad_check(derived=True)``).
    Returns {"model <GNN>+<scorer>": launches}."""
    launches, cfgs = {}, {}
    for gnn, scorer in MODEL_PAIRS:
        name = f"{gnn}+{scorer}"
        cfgs[name] = bench_config(pipeline="hybrid", GNN=gnn,
                                  edge_mlp_type=scorer, gat_heads=1)
        launches[f"model {name}"] = _train_path(
            torch, g, name, cfgs[name], MODEL_STEPS,
            model_launches(gnn, scorer), phase="model",
            full=(gnn, scorer) in MODEL_FULL)
        torch.cuda.empty_cache()
    for gnn, scorer in MODEL_FULL:
        _grad_check(torch, arrays, g, f"{gnn}+{scorer}",
                    cfgs[f"{gnn}+{scorer}"], derived=True)
        torch.cuda.empty_cache()
    return launches


# The dense phase's parity: dense_subgraph 'on' against 'off' on the card,
# frozen sample, no dropout, same weights. Both routes round the same
# operands, and each aggregation's output, to bf16 (the sparse route casts
# K1's f32 sums to the compute dtype where the product's output is bf16);
# they differ by the order of the f32 sums (atomics against the tensor
# cores' accumulation), which can flip a bf16 rounding. That is less than
# what separates the card's bf16 from f32, which the grad_check's limits
# (1% on the loss, GRAD_REL_TOL per gradient) bound; they bound it here.
DENSE_LOSS_RTOL = 1e-2


def _dense_parity(torch, g, name, cfg_kw):
    """One frozen-sample step without dropout on the card, dense_subgraph
    'on' against 'off', from the same weights and seeds: the loss within
    DENSE_LOSS_RTOL, each gradient within GRAD_REL_TOL (relative L2); a
    ``dense_parity`` line each with the conditional gate off (every
    parameter gets a gradient: the scorer's dense encoder is held) and on
    (the random forward is dense too; where the gate fails, the loss is
    the random forward's)."""
    for conditional in (False, True):
        _dense_parity_step(torch, g, name, dict(cfg_kw,
                                                conditional=conditional))


def _dense_parity_step(torch, g, name, cfg_kw):
    from sgs_gnn_tpu_torch import Config, get_model
    from sgs_gnn_tpu_torch.train import pipelines
    tiles = cfg_kw["pipeline"] == "hybrid"      # hybrid_rescore: tile space
    rng = np.random.default_rng(3)
    valid = np.flatnonzero((g.tile_mask if tiles else g.edge_mask)
                           .cpu().numpy())
    idx = torch.from_numpy(np.sort(rng.choice(valid, Q, replace=False))
                           .astype(np.int32))
    rand_idx = torch.from_numpy(rng.choice(N_EDGES, Q, replace=False)
                                .astype(np.int32))
    restore = _frozen_sampling(torch, pipelines, idx, rand_idx)
    out = {}
    try:
        for dense in ("off", "on"):
            cfg = Config(**dict(cfg_kw, drop_rate=0.0, dense_subgraph=dense))
            model = get_model(cfg.GNN, FEAT, NHID, CLASSES, 0.0,
                              cfg.edge_mlp_type, heads=cfg.gat_heads,
                              dtype=cfg.dtype, device=DEVICE,
                              generator=torch.Generator().manual_seed(5))
            loss, (gate, _, _) = pipelines.make_learned_loss(cfg, model, Q)(
                g, torch.Generator(device=DEVICE).manual_seed(0))
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            out[dense] = (float(loss.detach()), bool(gate), {
                n: (torch.zeros_like(p) if gr is None else gr).float()
                for n, p, gr in zip(names, params, grads)})
    finally:
        restore()
    (loss_s, gate_s, g_s), (loss_d, gate_d, g_d) = out["off"], out["on"]
    rel = {n: float((g_d[n] - w).norm() / w.norm())
           for n, w in g_s.items() if float(w.norm()) > 0}
    loss_rel = abs(loss_d - loss_s) / abs(loss_s)
    emit("dense_parity", path=name, conditional=cfg_kw["conditional"],
         loss_off=loss_s, loss_on=loss_d,
         loss_rel_err=loss_rel, gate_off=gate_s, gate_on=gate_d,
         grad_rel_l2_err=rel, max_grad_rel_l2_err=max(rel.values()),
         zero_gradients=sorted(set(g_s) - set(rel)),
         limits=dict(loss_rtol=DENSE_LOSS_RTOL, grad_rel_l2=GRAD_REL_TOL),
         note="card bf16, sample frozen, dropout off, same weights")
    check(gate_d == gate_s, f"dense {name}: gate on {gate_d}, off {gate_s}")
    check(all(bool(torch.isfinite(v).all()) for v in g_d.values()),
          f"dense {name}: non-finite gradients")
    check(loss_rel <= DENSE_LOSS_RTOL,
          f"dense {name}: loss on {loss_d} vs off {loss_s}")
    bad = {n: e for n, e in rel.items() if not e <= GRAD_REL_TOL}
    check(not bad, f"dense {name}: gradients on vs off (relative L2): {bad}")


def _dense_ops(torch, g, k1):
    """The dense route's two operations at the step's shapes: the (N, N)
    build of the random q-subgraph (``dense_adj``: ``index_add_`` of the
    validities into a zeroed flat buffer) and the (N, N) @ (N, F) bf16
    product of the GCN layers, each beside its bound and the K1 launch it
    replaces (``k1``: K1 on the sampled receivers, q=200k, F=256): CUDA
    events over back-to-back calls (``*_ms``) and over replays of a CUDA
    graph of 20 calls (``*_graph_ms``, paced by the device). The build is
    also timed on K2's "global" route over the N*N flat ids
    (``build_k2_*``; a comparison, no path launches it), and held to
    ``dense_adj``'s matrix."""
    from sgs_gnn_tpu_torch.ops import scatter as sc
    from sgs_gnn_tpu_torch.ops.dense_graph import dense_adj
    from sgs_gnn_tpu_torch.sparsify import sample_prior_edges
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    aux = g.edge_aux[sample_prior_edges(gen, g.prob, Q, g.edge_mask)]
    s, r = aux[:, 0].contiguous(), aux[:, 1].contiguous()
    valid = (aux[:, 2] & 4) > 0
    adj = dense_adj(s, r, N_NODES, valid=valid).adj
    ref = dense_adj(s.cpu(), r.cpu(), N_NODES, valid=valid.cpu()).adj
    check(torch.equal(adj.cpu(), ref),
          "dense_adj on the card differs from the CPU build (integer "
          "multiplicities: exact in any order)")
    build_bytes = 9 * Q + 4 * N_NODES * N_NODES   # ids, validity; adj
    flat = r * N_NODES + s
    w = valid.float()

    def k2_build():
        return sc.segment_sum_scalar(w, flat, N_NODES * N_NODES)
    check(torch.equal(k2_build().reshape(N_NODES, N_NODES), adj),
          "K2 over the flat ids differs from dense_adj")
    a16 = adj.to(torch.bfloat16)
    xs = torch.randn(N_NODES, NHID, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    got = (a16 @ xs).float()
    want = adj @ xs.float()
    err = float((got - want).norm() / want.norm())
    check(err <= 1e-2, f"dense product: relative L2 {err} against f32")
    flops = 2 * N_NODES * N_NODES * NHID
    prod_bytes = 2 * N_NODES * N_NODES + 2 * 2 * N_NODES * NHID
    row = dict(
        nodes=N_NODES, q=Q, max_multiplicity=float(adj.max()),
        build_ms=cuda_ms(torch, lambda: dense_adj(s, r, N_NODES,
                                                  valid=valid)),
        build_graph_ms=graph_ms(torch, lambda: dense_adj(s, r, N_NODES,
                                                         valid=valid)),
        build_k2_ms=cuda_ms(torch, k2_build),
        build_k2_graph_ms=graph_ms(torch, k2_build),
        build_bound_ms=build_bytes / HBM_BPS * 1e3, build_bound_by="bytes",
        build="index_add_ of the validities at r*N+s into a zeroed "
              "(N*N,) f32 buffer",
        cast_ms=cuda_ms(torch, lambda: adj.to(torch.bfloat16)),
        product_ms=cuda_ms(torch, lambda: a16 @ xs),
        product_graph_ms=graph_ms(torch, lambda: a16 @ xs),
        product_shape=f"({N_NODES},{N_NODES})@({N_NODES},{NHID}) bf16",
        product_rel_l2_err=err,
        product_bound_ms=max(flops / BF16_FLOPS,
                             prod_bytes / HBM_BPS) * 1e3,
        product_bound_by=("operations" if flops / BF16_FLOPS
                          > prod_bytes / HBM_BPS else "bytes"),
        k1_q200k_f256_ms=k1["ms"], k1_q200k_f256_device_ms=k1["device_ms"])
    row["product_bound_share"] = (row["product_bound_ms"]
                                  / row["product_graph_ms"])
    row["build_bound_share"] = row["build_bound_ms"] / row["build_graph_ms"]
    emit("dense_ops", **row)


def phase_dense(torch, g, kernels, sparse):
    """dense_subgraph='on' on the bench partition ``g`` for each of
    DENSE_PATHS: the ``_train_path`` of the train phase (warm-up, one
    launch-counted step under no_host_sync held to ``dense_launches``,
    timed steps, eager and graphed, a ``profile`` line per route) as a
    ``dense`` line; a ``dense_routes`` line of K1 and K2 per step on each
    route (``sparse``: the train and models phases' counted launches);
    then the parity checks (``_dense_parity``) and the two operations'
    times (``_dense_ops``). Returns {"dense <path>": launches}."""
    launches, cfgs = {}, {}
    for name, (pipeline, gnn) in DENSE_PATHS.items():
        cfgs[name] = bench_config(**PIPELINES[pipeline][0], GNN=gnn,
                                  dense_subgraph="on")
        launches[f"dense {name}"] = _train_path(
            torch, g, name, cfgs[name], PIPELINE_STEPS,
            dense_launches(pipeline, gnn), phase="dense")
        torch.cuda.empty_cache()
    off = {"hybrid_rescore": sparse["hybrid_rescore"],
           "two_pass": sparse["two_pass"],
           "GAT+GCN": sparse["model GAT+GCN"]}
    emit("dense_routes", per_step={
        name: {route: {k: n.get(k, 0) for k in ROWS}
               for route, n in (("off", off[name]),
                                ("on", launches[f"dense {name}"]))}
        for name in DENSE_PATHS},
        derived="off: PIPELINES / model_launches; on: dense_launches")
    for name in DENSE_PATHS:
        _dense_parity(torch, g, name, cfgs[name])
        torch.cuda.empty_cache()
    _dense_ops(torch, g, kernels["scatter_add"])
    return launches


# the parallel phase: the multi-rank paths under NCCL. The card's machine
# has one card and NCCL allows one rank per device, so the group has one
# rank: its all-reduces are the identity, and the exchange moves nothing.
PARALLEL_STEPS = 10           # timed steps of each side, in turns
# one step from equal parameters and equal draws: the two sides differ
# only in the order of f32 atomics (K1, K2, K5), so the loss and the
# gradients the optimizer receives agree to within that reordering (a
# second sequential copy gives its floor: on an H100 the two copies'
# parameters after one step were 86.8% bit-equal, the rest moved by up to
# 4 lr, Adam's first step being +-lr per group on a gradient's sign)
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_GRAD_REL = 1e-2      # relative L2 per gradient


@contextlib.contextmanager
def _captured_grads(opts, method):
    """Inside: each optimizer's ``method`` records the gradients it
    receives (one list per optimizer, replaced at every call). On exit the
    class's method is back and the recorder's reference cycle gone."""
    got = [[] for _ in opts]
    for opt, rec in zip(opts, got):
        def recording(grads, *args, _inner=getattr(opt, method), _rec=rec):
            _rec[:] = [gr.detach().clone() for gr in grads]
            return _inner(grads, *args)
        setattr(opt, method, recording)
    try:
        yield got
    finally:
        for opt in opts:
            delattr(opt, method)


def _grad_gaps(names, got, want):
    """{name: relative L2 of got - want}, over the gradients one step
    handed its optimizer."""
    out = {}
    for n, a, b in zip(names, got, want):
        den = float(b.float().norm())
        out[n] = float((a.float() - b.float()).norm()) / max(den, 1e-30) \
            if den > 0 else float(a.float().norm())
    return out


def _param_gap(a, b):
    """max |a - b| over the parameters and the share that are bit-equal."""
    gaps, equal, total = [], 0, 0
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        d = (x.detach() - y.detach()).abs()
        gaps.append(float(d.max()))
        equal += int((d == 0).sum())
        total += d.numel()
    return max(gaps), equal / total


def _turns(torch, steps, n):
    """Host ms per step of each of ``steps`` ({name: fn}), ``n`` steps
    per block, two blocks each in turns (a b b a); returns {name: [ms,
    ms]}."""
    names = list(steps)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            steps[k](i)
        torch.cuda.synchronize()
        out[k].append((time.perf_counter() - t0) / n * 1e3)
    return out


def _fresh_model(torch, cfg, in_channels, classes):
    from sgs_gnn_tpu_torch import DualOptimizer, get_model
    model = get_model(cfg.GNN, in_channels, cfg.nhid, classes, cfg.drop_rate,
                      cfg.edge_mlp_type, heads=cfg.gat_heads,
                      dtype=cfg.dtype, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    return model, DualOptimizer.create(model, cfg.GNN, cfg.lr,
                                       cfg.weight_decay)


def phase_parallel(torch, g):
    """The process group and the data-parallel super-step on the bench
    partition ``g`` (``train_graph``), bench.py's hybrid_rescore flags: a
    one-rank NCCL group on the card (``init_distributed``); its bucketed
    all-reduce must return its input bit for bit; one super-step
    (``make_parallel_train_step``) against the sequential step
    (``make_train_step``) from equal parameters and the same draws (a
    second sequential copy gives the reordering floor): the loss within
    PARALLEL_LOSS_RTOL, the gate equal, every gradient the optimizer
    receives within PARALLEL_GRAD_REL (relative L2), the parameters after
    the update reported beside the floor's; one launch-counted
    super-step under no_host_sync, held to the sequential step's counts;
    both sides timed in turns and profiled. A ``parallel_step`` line;
    returns {"parallel_dp_step": launches}."""
    from sgs_gnn_tpu_torch import Config, make_train_step
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    from sgs_gnn_tpu_torch.parallel import (backend_for, init_distributed,
                                            make_parallel_train_step,
                                            rank_seed)
    from sgs_gnn_tpu_torch.parallel.partitioned import all_reduce_mean
    allocated_before = torch.cuda.memory_allocated()
    mesh = init_distributed(device=DEVICE)
    check((mesh.world, mesh.rank, mesh.backend, mesh.device.type)
          == (1, 0, backend_for(DEVICE), torch.device(DEVICE).type),
          f"process group {mesh}")
    probe = [torch.randn(1000, 257, device=DEVICE),
             torch.randn(3, device=DEVICE)]
    check(all(torch.equal(a, b) for a, b in
              zip(all_reduce_mean(probe, mesh), probe)),
          "the all-reduce of one rank changed its input")

    name, (overrides, _, expect) = "hybrid_rescore", \
        PIPELINES["hybrid_rescore"]
    cfg = Config(**bench_config(**overrides))
    (m_seq, o_seq), (m_ref, o_ref), (m_dp, o_dp) = (
        _fresh_model(torch, cfg, FEAT, CLASSES) for _ in range(3))
    seq = make_train_step(cfg, m_seq, o_seq, Q, PARALLEL_STEPS * 4)
    ref = make_train_step(cfg, m_ref, o_ref, Q, PARALLEL_STEPS * 4)
    dp = make_parallel_train_step(cfg, m_dp, o_dp, Q, PARALLEL_STEPS * 4,
                                  mesh)
    gen = torch.Generator(device=DEVICE)

    def seq_step(step, epoch, seed):
        return step(g, epoch, gen.manual_seed(rank_seed(seed, 0)))

    with _captured_grads((o_seq, o_ref, o_dp), "step_learned") as grads:
        s1 = seq_step(seq, 0, 11)
        s2 = seq_step(ref, 0, 11)
        d1 = dp(g, 0, 11, gen)
    losses = [float(s1.loss), float(s2.loss), float(d1.loss)]
    gates = [float(s1.conditional_update), float(d1.conditional_update)]
    gap, equal = _param_gap(m_dp, m_seq)
    floor, floor_equal = _param_gap(m_ref, m_seq)
    grad_gap = _grad_gaps(o_seq.names, grads[2], grads[0])
    grad_floor = _grad_gaps(o_seq.names, grads[1], grads[0])
    check(abs(losses[2] - losses[0]) <= PARALLEL_LOSS_RTOL * abs(losses[0])
          and gates[0] == gates[1],
          f"super-step of one rank: loss {losses}, gates {gates}")
    check(max(grad_gap.values()) <= PARALLEL_GRAD_REL,
          f"super-step of one rank: gradients {grad_gap} (floor "
          f"{grad_floor})")

    torch.cuda.synchronize()
    LAUNCHES.clear()
    with no_host_sync(torch):
        dp(g, 1, 12, gen)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    check(launches == expect, f"super-step launches {launches}, the "
                              f"sequential step's {expect}")
    times = _turns(torch, {
        "sequential": lambda i: seq_step(seq, 2 + i, 100 + i),
        "super_step": lambda i: dp(g, 2 + i, 100 + i, gen)}, PARALLEL_STEPS)
    prof = {"sequential": profile_breakdown(
                torch, lambda: seq_step(seq, 30, 200)),
            "super_step": profile_breakdown(torch, lambda: dp(g, 30, 200,
                                                              gen))}
    emit("parallel_step", pipeline=name, world=mesh.world,
         backend=mesh.backend, config=bench_config(**overrides),
         nodes=N_NODES, edges=N_EDGES, q=Q, losses=losses, gates=gates,
         loss_rtol=PARALLEL_LOSS_RTOL,
         grad_rel_l2_max=max(grad_gap.values()),
         grad_rel_l2_floor_max=max(grad_floor.values()),
         grad_rel_limit=PARALLEL_GRAD_REL, grad_rel_l2=grad_gap,
         param_max_abs_gap=gap, param_bit_equal_share=equal,
         sequential_floor_gap=floor,
         sequential_floor_bit_equal_share=floor_equal,
         lr=cfg.lr, launches_per_step=launches,
         step_ms=times,
         device_busy_ms={k: v["device_busy_ms"] for k, v in prof.items()},
         idle_share={k: v["idle_share"] for k, v in prof.items()})
    for k, v in prof.items():
        emit("profile", call=f"parallel {k} step {name}", **v)
    del m_seq, m_ref, m_dp, o_seq, o_ref, o_dp, seq, ref, dp, grads
    gc.collect()
    torch.cuda.empty_cache()
    emit("parallel_memory", allocated_before=allocated_before,
         allocated_after=torch.cuda.memory_allocated())
    return {"parallel_dp_step": launches}


def _halo_parity(torch, ds):
    """One full-mode halo step at world 1 (the whole experiment graph on
    one rank: the halo route's gathers and segment sums, no exchange)
    against the full-graph full-mode step on the same edge list, from
    equal parameters and the same draws, in f32 (the two differ only in
    the order of f32 atomics; bf16 would add the sequential route's one
    rounding of the aggregate to bf16, which the halo route's f32
    segment sum does not do, as in JAX): the loss within
    PARALLEL_LOSS_RTOL, every gradient the optimizer receives within
    PARALLEL_GRAD_REL; timed in turns. A ``halo_step`` line; returns
    {"parallel_halo_step": launches}."""
    from sgs_gnn_tpu_torch import Config, Graph, make_train_step
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    from sgs_gnn_tpu_torch.parallel import (build_halo_batch,
                                            init_distributed,
                                            make_halo_train_step, rank_seed)
    mesh = init_distributed(device=DEVICE)
    cfg = Config(mode="full", nhid=NHID, dtype="float32")
    t0 = time.perf_counter()
    hb = build_halo_batch(ds.x, ds.edge_index, ds.y, ds.train_mask,
                          ds.val_mask, ds.test_mask, ds.prob, 1,
                          ds.num_classes, rank=0, device=DEVICE)
    build_s = time.perf_counter() - t0
    gfull = Graph.build(ds.x, ds.edge_index, ds.y, ds.train_mask,
                        ds.val_mask, ds.test_mask, prob=ds.prob,
                        num_classes=ds.num_classes, device=DEVICE)
    check(torch.equal(hb.senders_ext, gfull.senders)
          and torch.equal(hb.receivers_loc, gfull.receivers)
          and hb.round_sizes == () and hb.ext_rows == 0,
          "halo batch of one rank is not the graph's edge list")
    (m_seq, o_seq), (m_halo, o_halo) = (
        _fresh_model(torch, cfg, ds.x.shape[1], ds.num_classes)
        for _ in range(2))
    seq = make_train_step(cfg, m_seq, o_seq, gfull.num_edges, 10)
    halo = make_halo_train_step(cfg, m_halo, o_halo, 10, mesh)
    gen = torch.Generator(device=DEVICE)
    with _captured_grads((o_seq, o_halo), "step_all") as grads:
        s1 = seq(gfull, 0, gen.manual_seed(rank_seed(21, 0)))
        h1 = halo(hb, 0, 21, gen)
    losses = [float(s1.loss), float(h1.loss)]
    gap, equal = _param_gap(m_halo, m_seq)
    grad_gap = _grad_gaps(o_seq.names, grads[1], grads[0])
    check(abs(losses[1] - losses[0]) <= PARALLEL_LOSS_RTOL * abs(losses[0]),
          f"halo step of one rank: losses {losses}")
    check(max(grad_gap.values()) <= PARALLEL_GRAD_REL,
          f"halo step of one rank: gradients {grad_gap}")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    with no_host_sync(torch):
        halo(hb, 1, 22, gen)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    check(set(launches) == set(ROWS), f"halo full step launches {launches}")
    times = _turns(torch, {
        "full_graph": lambda i: seq(gfull, 2 + i, gen.manual_seed(
            rank_seed(300 + i, 0))),
        "halo": lambda i: halo(hb, 2 + i, 300 + i, gen)}, 3)
    prof = {"full_graph": profile_breakdown(torch, lambda: seq(
                gfull, 9, gen.manual_seed(rank_seed(400, 0)))),
            "halo": profile_breakdown(torch, lambda: halo(hb, 9, 400, gen))}
    emit("halo_step", mode="full", world=mesh.world, dtype=cfg.dtype,
         nodes=ds.num_nodes, edges=ds.num_edges, nhid=NHID,
         halo_batch_build_s=build_s, losses=losses,
         loss_rtol=PARALLEL_LOSS_RTOL,
         grad_rel_l2_max=max(grad_gap.values()),
         grad_rel_limit=PARALLEL_GRAD_REL, param_max_abs_gap=gap,
         param_bit_equal_share=equal, lr=cfg.lr,
         launches_per_step=launches, step_ms=times,
         device_busy_ms={k: v["device_busy_ms"] for k, v in prof.items()},
         idle_share={k: v["idle_share"] for k, v in prof.items()})
    for k, v in prof.items():
        emit("profile", call=f"halo {k} step (full mode, f32)", **v)
    del hb, gfull, m_seq, m_halo, o_seq, o_halo, seq, halo, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"parallel_halo_step": launches}


# the driver's multi-rank paths on the experiment cell, 2 epochs each
PARALLEL_RUNS = (("learned", "data_parallel", ("--data_parallel", "on")),
                 ("learned", "halo", ("--halo", "true")),
                 ("full", "halo", ("--halo", "true")))
HALO_LEARNED = ("scatter_add", "segment_sum_scalar", "score_head_sampled",
                "score_head_bwd")


def phase_parallel_experiment(torch, ds, results_dir):
    """The halo step's parity (``_halo_parity``), then each of
    PARALLEL_RUNS through the CLI's parser and run_experiment with every
    launch counter at 0 just before it: an ``experiment`` line each
    (route, world, plan, epoch and eval times, losses, F1s, launches per
    epoch). Learned data_parallel must launch K1-K6 (the tile index
    engages on the card); learned halo K1, K2, K3 and K5 (the head runs
    on the extended table; no tile index); full halo K1 and K2 only.
    Returns {path: launches}."""
    from sgs_gnn_tpu_torch.run.cli import config_from_args
    paths = _halo_parity(torch, ds)
    for mode, route, flags in PARALLEL_RUNS:
        label = f"{mode} {route}"
        cfg = config_from_args(experiment_args(
            mode, results_dir, extra=[*flags, "--save_csv", "false"]))
        res, lines, per_epoch, launches, seconds = run_experiment_counted(
            torch, cfg, ds, label)
        _check_result(label, res)
        check(any(ln.startswith("[fastpath] epoch=per-batch loop ("
                                + route) for ln in lines),
              f"{label}: the route's [fastpath] line is missing")
        stats = next(ln for ln in lines if ln.startswith("[stats]"))
        check(f"{'parallel' if route == 'data_parallel' else 'halo'}=1"
              in stats, f"{label}: {stats}")
        if route == "data_parallel":
            _check_launches(mode, route, launches)
            check(res.total_updates == EXPERIMENT_EPOCHS
                  * res.plan["parts"], f"{label}: {res.total_updates} "
                                       "updates")
        elif mode == "learned":
            check(set(launches) == set(HALO_LEARNED),
                  f"{label}: launched {launches}")
        else:
            check(set(launches) == set(ROWS), f"{label}: launched "
                                              f"{launches}")
        emit("experiment", mode=mode, route=route, model="GCN+GCN",
             nodes=ds.num_nodes, edges=ds.num_edges, plan=res.plan,
             epoch_s=res.epoch_times,
             eval_ms=[t * 1e3 for t in res.eval_times],
             edges_per_s_steady=res.edges_per_s_steady, run_s=seconds,
             losses=res.losses, total_updates=res.total_updates,
             final_f1=dict(train=res.final_train_f1, val=res.final_val_f1,
                           test=res.final_test_f1),
             peak_device_mem_mb=res.peak_device_mem_mb,
             launches_per_epoch=per_epoch, launches=launches,
             fastpath=[ln for ln in lines if ln.startswith("[fastpath]")],
             stats=stats)
        paths[f"experiment_{mode}_{route}"] = launches
        torch.cuda.empty_cache()
    return paths


EVAL_REPEATS = 5


def _eval_step_line(torch, cfg, ds):
    """``make_eval_step`` timed alone on the experiment cell's partitions
    (the learned configuration, eager): per batch and per eval of every
    batch, host clock to a sync, EVAL_REPEATS times, and one profiled
    eval. An ``eval_step`` line."""
    from sgs_gnn_tpu_torch import make_eval_step
    from sgs_gnn_tpu_torch.eval import accumulate_eval_device, aggregate_eval
    from sgs_gnn_tpu_torch.run import driver
    batches, q, _ = driver.prepare_batches(cfg, ds, DEVICE)
    model, _ = _fresh_model(torch, cfg, ds.x.shape[1], ds.num_classes)
    valid = [int(b.edge_mask.sum()) for b in batches]
    evals = {False: make_eval_step(cfg, model, q),
             True: make_eval_step(cfg, model, q, force_small=True)}
    gen = torch.Generator(device=DEVICE)

    def eval_all():
        acc = None
        for b, v in zip(batches, valid):
            acc = accumulate_eval_device(acc, evals[v <= q](
                b, gen.manual_seed(5)))
        return acc

    aggregate_eval([eval_all()])                 # warm-up
    per_eval = []
    for _ in range(EVAL_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg = aggregate_eval([eval_all()])
        per_eval.append((time.perf_counter() - t0) * 1e3)
    per_batch = []
    for b, v in zip(batches, valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evals[v <= q](b, gen.manual_seed(5))
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3)
    prof = profile_breakdown(torch, eval_all)
    emit("eval_step", mode=cfg.mode, batches=len(batches), q=q,
         draws=cfg.num_samples_eval, edges=[b.num_edges for b in batches],
         eval_ms=per_eval, batch_ms=per_batch,
         device_busy_ms=prof["device_busy_ms"],
         idle_share=prof["idle_share"], f1=agg)
    emit("profile", call="make_eval_step over every partition (learned)",
         **prof)
    del batches, model
    torch.cuda.empty_cache()


# the experiment phase: a Reddit-shaped graph (the port's
# community_sbm_graph at Reddit's widths: 602 features, 41 classes,
# deg=330) small enough for ~5 native partitions of ~1M kept edges at
# metis_threshold=1M, driven through run_experiment with
# Scripts/run_reddit_scale.sh's flags
EXPERIMENT_NODES, EXPERIMENT_COMMUNITIES = 9_100, 5
EXPERIMENT_THRESHOLD, EXPERIMENT_EPOCHS = 1_000_000, 2
EXPERIMENT_MODES = ("learned", "random", "edge", "full")
SYNC_CHECKED_EPOCH = 1        # the batch loop run under no_host_sync
# graphed against eager from the same seeds: the same draws, and sums
# that differ only in the order of f32 atomics (K1, K2, K5), which may
# flip a prediction whose logits tie within that reordering. Set from the
# readings on an H100 (three runs of this script): losses equal to a
# relative 6.6e-6 at most, F1s within 2.6e-3 (a few nodes); the limits
# leave 15x and 2x of room
EXPERIMENT_LOSS_RTOL = 1e-4
EXPERIMENT_F1_ATOL = 5e-3
# The GAT backbone with the GraphSAGE scorer is noisier run to run: two
# eager runs of its learned experiment from the same seeds gave epoch
# losses a relative 4.1e-3 apart (graphed vs eager 1.9e-3 to 2.2e-3; the
# GCN pair 2.1e-5 at most; F1 curves equal), on an H100
# (tools/graphed_readings.py experiment_noise). Its loss limit leaves ~5x
# of the eager runs' own spread; its F1 limit is the GCN pair's.
MODEL_EXPERIMENT_LOSS_RTOL = {"GCN+GCN": EXPERIMENT_LOSS_RTOL,
                              "GAT+GSAGE": 2e-2}
# Scripts/run_memory.sh's flags that experiment_args lacks, and
# --debug_checks: the experiment line of the diagnostics
MEMORY_FLAGS = ("--hybrid_checkpoint", "True", "--gpu_profile", "True",
                "--debug_checks", "True", "--save_csv", "false")
SEGMENTS = ("edge_mlp_pre", "edge_score", "gnn_forward", "backward")
HEADS = ("score_head_sampled", "score_head_sampled_banded",
         "score_head_bwd", "score_head_tiles")
ROWS = ("scatter_add", "segment_sum_scalar")
# the quality phase: tests/test_quality.py's configuration (:14-21)
QUALITY_MODES = ("learned", "random", "full")
QUALITY_KW = dict(dataset="SyntheticSBMLow", pipeline="hybrid", GNN="GCN",
                  edge_mlp_type="GCN", conditional=True, reg1=True,
                  reg2=True, sample_perc=0.2, nhid=64, epochs=60, runs=1,
                  save_csv=False, num_samples_eval=3, convergence=0.0)
# the JAX package's final test F1s in this configuration (QUALITY_KW, the
# driver's seed 42), on the CPU at commit cfd9fb2: the reference's quality,
# not numbers of the port (tools/quality_reference.py)
QUALITY_JAX_REFERENCE = dict(
    f1=dict(learned=0.70375, random=0.2825, full=0.3825),
    source="JAX package, CPU, commit cfd9fb2, seed 42, QUALITY_KW "
           "(tools/quality_reference.py)")


def experiment_dataset():
    """The experiment's HostDataset, prepared as get_dataset prepares a
    synthetic fixture (undirected, degree prior, edge homophily)."""
    from sgs_gnn_tpu_torch.data import (HostDataset, community_sbm_graph,
                                        degree_prior, edge_homophily,
                                        to_undirected)
    x, ei, y, (tr, va, te) = community_sbm_graph(
        n=EXPERIMENT_NODES, communities=EXPERIMENT_COMMUNITIES, seed=0)
    ei = to_undirected(ei)
    return HostDataset(
        name=f"SyntheticReddit{EXPERIMENT_NODES}", x=x, edge_index=ei, y=y,
        train_mask=tr, val_mask=va, test_mask=te,
        prob=degree_prior(ei[0], ei[1], EXPERIMENT_NODES),
        num_classes=int(y.max()) + 1, He=edge_homophily(ei, y))


def experiment_args(mode, results_dir, epochs=EXPERIMENT_EPOCHS, extra=()):
    """Scripts/run_reddit_scale.sh's flags (TPU-only ones left out) for
    the port's CLI parser."""
    return ["--dataset", "SyntheticReddit", "--mode", mode, "--runs", "1",
            "--epochs", str(epochs), "--edge_mlp_type", "GCN", "--GNN",
            "GCN", "--sparse_edge_mlp", "true", "--conditional", "true",
            "--reg1", "true", "--reg2", "true", "--sample_perc", "0.2",
            "--pipeline", "hybrid", "--metis_threshold",
            str(EXPERIMENT_THRESHOLD), "--dtype", "bfloat16", "--nhid",
            "256", "--num_samples_eval", "11", "--convergence", "0",
            "--save_csv", "true", "--stats", "true", "--log", "true",
            "--results_dir", results_dir, *extra]


def check_padded_rows(torch, cfg, ds):
    """K1 and K2 against their plain versions on the partition with the
    most padding: its receivers end in one run of ghost-node ids (every
    padding edge is a self-loop on node max_n - 1)."""
    from sgs_gnn_tpu_torch.ops import scatter as sc
    from sgs_gnn_tpu_torch.run import driver
    batches, q, _ = driver.prepare_batches(cfg, ds, DEVICE)
    valid = [int(g.edge_mask.sum()) for g in batches]
    bi = max(range(len(batches)),
             key=lambda i: batches[i].num_edges - valid[i])
    g = batches[bi]
    ghost = g.num_nodes - 1
    pad = g.num_edges - valid[bi]
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    out = dict(batch=bi, edges=g.num_edges, valid_edges=valid[bi],
               ghost_ids=pad, cases=[])
    check(pad > 0 and int((g.receivers == ghost).sum()) >= pad,
          f"padded batch {bi}: {pad} padding edges")
    for name, ids in (("receivers", g.receivers), ("senders", g.senders)):
        vals = torch.randn(g.num_edges, NHID, generator=gen,
                           device=DEVICE).to(torch.bfloat16)
        got = sc.scatter_add(vals, ids, g.num_nodes)
        ref = sc.scatter_add_plain(vals, ids, g.num_nodes)
        tol = sum_tolerance(sc.scatter_add_plain(vals.abs(), ids,
                                                 g.num_nodes))
        err = float((got - ref).abs().max())
        check(bool(((got - ref).abs() <= tol).all()),
              f"K1 on padded {name}: error {err} above the tolerance")
        out["cases"].append(dict(kernel="scatter_add", ids=name, F=NHID,
                                 max_abs_err=err))
    w = torch.rand(g.num_edges, generator=gen, device=DEVICE)
    got = sc.segment_sum_scalar(w, g.receivers, g.num_nodes)
    ref = sc.segment_sum_scalar_plain(w, g.receivers, g.num_nodes)
    err = float((got - ref).abs().max())
    check(bool(((got - ref).abs() <= sum_tolerance(ref)).all()),
          f"K2 on padded receivers: error {err} above the tolerance")
    out["cases"].append(dict(kernel="segment_sum_scalar", ids="receivers",
                             max_abs_err=err, ghost_sum=float(got[ghost]),
                             ghost_sum_plain=float(ref[ghost])))
    emit("padded_rows", tolerance="1e-5 of the summed magnitudes per row "
         "+ 1e-6", **out)
    del batches
    torch.cuda.empty_cache()


def run_experiment_counted(torch, cfg, ds, label, profile_epoch=None):
    """One run_experiment of the card with every launch counter at 0 just
    before it: launches by kernel per epoch (train and eval, cut at the
    driver's [epoch-time] and [eval-time] lines) and the batch loop of
    epoch SYNC_CHECKED_EPOCH under no_host_sync, which fails on any wait
    of the host for the card and says where. With ``profile_epoch`` that
    epoch's batch loop runs under torch.profiler (a ``profile`` line)."""
    import collections
    import traceback
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    from sgs_gnn_tpu_torch.run import driver
    lines, per_epoch = [], {"train": [], "eval": []}
    last = collections.Counter()

    def log_fn(line):
        lines.append(line)
        m = re.match(r"\[(epoch|eval)-time\] epoch=(\d+)", line)
        if m:
            now = collections.Counter(LAUNCHES)
            per_epoch["train" if m.group(1) == "epoch" else "eval"].append(
                dict(now - last))
            last.clear()
            last.update(now)

    train_epoch = driver._train_epoch

    def checked(*args):
        epoch = args[4]
        if epoch == profile_epoch:
            out = []
            emit("profile", call=f"{label} batch loop of epoch {epoch}",
                 **profile_breakdown(torch,
                                     lambda: out.append(train_epoch(*args))))
            return out[0]
        if epoch != SYNC_CHECKED_EPOCH:
            return train_epoch(*args)
        torch.cuda.synchronize()
        try:
            with no_host_sync(torch):
                return train_epoch(*args)
        except RuntimeError as exc:
            where = "".join(traceback.format_exc(limit=-6).splitlines(True)
                            [-14:])
            raise SmokeFailure(f"{label}: the batch loop of epoch {epoch} "
                               f"waited for the card: {exc}\n{where}")
    driver._train_epoch = checked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        (res,) = driver.run_experiment(cfg, ds, log_fn=log_fn,
                                       device=DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        driver._train_epoch = train_epoch
    return res, lines, per_epoch, launches, seconds


def _check_result(label, res):
    check(all(np.isfinite(res.losses)) and res.losses,
          f"{label}: losses {res.losses}")
    f1s = [res.final_train_f1, res.final_val_f1, res.final_test_f1]
    f1s += res.train_curve + res.val_curve + res.test_curve
    check(all(0.0 <= f <= 1.0 for f in f1s), f"{label}: F1s {f1s}")


def _experiment_line(mode, ds, data_s, res, lines, per_epoch, launches,
                     seconds, route, model):
    plan = res.plan
    emit("experiment", mode=mode, route=route, model=model,
         nodes=ds.num_nodes,
         edges=ds.num_edges, features=ds.x.shape[1],
         classes=ds.num_classes, he=ds.He, dataset_s=data_s,
         parts=plan["parts"], q=plan["q"],
         partitioner=plan["partitioner"],
         shape_classes=plan["shape_classes"],
         valid_edges=plan["valid_edges"],
         batches_per_epoch=dict(big=plan["big"], small=plan["small"],
                                skipped=plan["skipped"]),
         epoch_s=res.epoch_times,
         eval_ms=[t * 1e3 for t in res.eval_times],
         edges_per_s_steady=res.edges_per_s_steady,
         run_s=seconds, losses=res.losses,
         final_f1=dict(train=res.final_train_f1,
                       val=res.final_val_f1,
                       test=res.final_test_f1),
         peak_device_mem_mb=res.peak_device_mem_mb,
         launches_per_epoch=per_epoch, launches=launches,
         graphs=res.graphs, sync_checked_epoch=SYNC_CHECKED_EPOCH,
         fastpath=[ln for ln in lines
                   if ln.startswith(("[fastpath]", "[batches]"))],
         stats=next(ln for ln in lines if ln.startswith("[stats]")))


def _check_launches(mode, route, launches):
    heads = {k: launches.get(k, 0) for k in HEADS}
    check(all(launches.get(k, 0) > 0 for k in ROWS),
          f"{mode} {route}: K1/K2 not launched: {launches}")
    if mode == "learned":
        check(all(heads.values()), f"learned {route}: a head kernel (K3-K6) "
                                   f"was not launched: {launches}")
    else:
        check(set(launches) == set(ROWS),
              f"{mode} {route}: launched more than K1 and K2: {launches}")


def _compare_routes(mode, graphed, eager, model="GCN+GCN"):
    """The graphed run against the eager one from the same seeds: the same
    launches per epoch (the graphs' tallies) and, epoch by epoch, losses
    and F1s as close as draws that agree but for keys within f32
    reordering of each other allow."""
    (res_g, per_g), (res_e, per_e) = graphed, eager
    n = min(len(res_g.losses), len(res_e.losses))
    for part in ("train", "eval"):
        check(per_g[part][:n] == per_e[part][:n],
              f"{mode}: {part} launches per epoch graphed {per_g[part]} "
              f"vs eager {per_e[part]}")
    loss_rel = [abs(a - b) / max(abs(b), 1e-12)
                for a, b in zip(res_g.losses[:n], res_e.losses[:n])]
    f1_abs = [abs(a - b) for c in ("train_curve", "val_curve", "test_curve")
              for a, b in zip(getattr(res_g, c)[:n], getattr(res_e, c)[:n])]
    loss_rtol = MODEL_EXPERIMENT_LOSS_RTOL[model]
    check(max(loss_rel) <= loss_rtol,
          f"{mode} {model}: graphed vs eager losses {res_g.losses} / "
          f"{res_e.losses} (rtol {loss_rtol})")
    check(max(f1_abs) <= EXPERIMENT_F1_ATOL,
          f"{mode}: graphed vs eager F1s differ by {max(f1_abs)} (limit "
          f"{EXPERIMENT_F1_ATOL})")
    emit("experiment_routes", mode=mode, model=model, epochs=n,
         epoch_s=dict(graphed=res_g.epoch_times, eager=res_e.epoch_times),
         eval_ms=dict(graphed=[t * 1e3 for t in res_g.eval_times],
                      eager=[t * 1e3 for t in res_e.eval_times]),
         launches_per_epoch_equal=True, loss_rel_err=loss_rel,
         loss_rtol=loss_rtol,
         f1_max_abs_err=max(f1_abs), graphs=res_g.graphs,
         peak_device_mem_mb=dict(graphed=res_g.peak_device_mem_mb,
                                 eager=res_e.peak_device_mem_mb))


def _experiment_route(torch, cfg, ds, data_s, mode, route, model,
                      profile=None):
    """One run_experiment of ``cfg`` (``route`` graphed or eager) with its
    checks and its ``experiment`` line; returns (result, launches per
    epoch, launches)."""
    label = f"{mode} {route}" + ("" if model == "GCN+GCN" else f" {model}")
    res, lines, per_epoch, launches, seconds = run_experiment_counted(
        torch, cfg, ds, label, profile_epoch=profile)
    _check_result(label, res)
    check(res.plan["partitioner"] == "native",
          f"{label}: partitioner {res.plan['partitioner']}")
    want, line = (("graphed", "[fastpath] epoch=graphed")
                  if route == "graphed" else
                  ("loop", "[fastpath] epoch=per-batch loop"))
    check(res.epoch_route == want
          and any(ln.startswith(line) for ln in lines),
          f"{label}: ran the {res.epoch_route} route")
    if route == "graphed":
        check(res.graphs["train_replays"] > 0
              and res.graphs["eval_replays"] > 0,
              f"{label}: graphs {res.graphs}")
    _check_launches(mode, route, launches)
    _experiment_line(mode, ds, data_s, res, lines, per_epoch, launches,
                     seconds, route, model)
    torch.cuda.empty_cache()
    return res, per_epoch, launches


def phase_experiment(torch):
    """Each mode through run_experiment at full width, graphed
    (scan_epoch=auto) and eager (scan_epoch=off) in turns, then a resume,
    then learned with the GAT backbone and the GraphSAGE scorer (the
    models phase's first full pair) graphed and eager; returns {path:
    launches} for the kernels line."""
    import csv
    import tempfile
    from sgs_gnn_tpu_torch.run.cli import config_from_args
    t0 = time.perf_counter()
    ds = experiment_dataset()
    data_s = time.perf_counter() - t0
    paths = {}
    with tempfile.TemporaryDirectory() as results_dir:
        cfgs = {m: config_from_args(experiment_args(
            m, results_dir, extra=(["--checkpoint_every", "1"]
                                   if m == "learned" else [])))
            for m in EXPERIMENT_MODES}
        check_padded_rows(torch, cfgs["learned"], ds)
        results = {}
        for mode, cfg in cfgs.items():
            runs = {}
            for route in ("graphed", "eager"):
                if route == "graphed":
                    run_cfg, profile = cfg, None
                else:
                    # the eager per-batch loop; learned runs one more epoch,
                    # profiled, for the idle share beside the graphed one
                    extra = ["--scan_epoch", "off", "--save_csv", "false"]
                    epochs = EXPERIMENT_EPOCHS + (mode == "learned")
                    run_cfg = config_from_args(experiment_args(
                        mode, results_dir, epochs=epochs, extra=extra))
                    profile = EXPERIMENT_EPOCHS if mode == "learned" else None
                res, per_epoch, launches = _experiment_route(
                    torch, run_cfg, ds, data_s, mode, route, "GCN+GCN",
                    profile)
                runs[route] = (res, per_epoch)
                paths[f"experiment_{mode}" + ("" if route == "graphed"
                                              else "_eager")] = launches
            _compare_routes(mode, runs["graphed"], runs["eager"])
            results[mode] = runs["graphed"][0]
        with open(f"{results_dir}/{ds.name}/0.2.csv") as fh:
            rows = list(csv.reader(fh))[1:]
        check([r[3] for r in rows] == list(EXPERIMENT_MODES),
              f"CSV rows {rows}")

        # resume: learned checkpointed every epoch; graphed on to epoch 4,
        # its first epoch capturing, the second profiled (replays only)
        cfg = config_from_args(experiment_args(
            "learned", results_dir, epochs=EXPERIMENT_EPOCHS + 2,
            extra=["--resume", "true", "--save_csv", "false"]))
        res, lines, _, launches, seconds = run_experiment_counted(
            torch, cfg, ds, "resume", profile_epoch=EXPERIMENT_EPOCHS + 1)
        _check_result("resume", res)
        before = results["learned"].losses
        check(res.start_epoch == EXPERIMENT_EPOCHS
              and res.losses[:EXPERIMENT_EPOCHS] == before
              and len(res.losses) == EXPERIMENT_EPOCHS + 2,
              f"resume: start {res.start_epoch}, losses {res.losses} "
              f"after {before}")
        check(res.epoch_route == "graphed", f"resume: {res.epoch_route}")
        emit("experiment", mode="learned_resumed", route=res.epoch_route,
             start_epoch=res.start_epoch, losses=res.losses,
             epoch_s=res.epoch_times, run_s=seconds, graphs=res.graphs,
             final_f1=dict(train=res.final_train_f1, val=res.final_val_f1,
                           test=res.final_test_f1),
             resumed_line=next(ln for ln in lines
                               if ln.startswith("resumed run")))

        # GAT + GraphSAGE scorer: learned, graphed and eager in turns
        gnn, scorer = MODEL_FULL[0]
        model, runs = f"{gnn}+{scorer}", {}
        for route in ("graphed", "eager"):
            extra = ["--GNN", gnn, "--edge_mlp_type", scorer,
                     "--save_csv", "false"]
            if route == "eager":
                extra += ["--scan_epoch", "off"]
            cfg = config_from_args(experiment_args("learned", results_dir,
                                                   extra=extra))
            check(cfg.GNN == gnn and cfg.edge_mlp_type == scorer,
                  f"{model}: parsed {cfg.GNN} + {cfg.edge_mlp_type}")
            res, per_epoch, launches = _experiment_route(
                torch, cfg, ds, data_s, "learned", route, model)
            runs[route] = (res, per_epoch)
            paths[f"experiment_learned_{model}" + (
                "" if route == "graphed" else "_eager")] = launches
        _compare_routes("learned", runs["graphed"], runs["eager"], model)
        paths["experiment_learned_memory_flags"] = _memory_flags_run(
            torch, ds, results_dir, results["learned"])
        _eval_step_line(torch, cfgs["learned"], ds)
    torch.cuda.empty_cache()
    return paths


def _memory_flags_run(torch, ds, results_dir, plain):
    """Learned on the cell with Scripts/run_memory.sh's flags and
    --debug_checks (graphed): every epoch's ``[gpu-profile]`` line holds
    the four segments' ms and MiB, finite and >= 0, some MiB > 0; the
    ``[stats]`` peak is not lowered by the profiler's resets of the peak
    statistics (at least ``plain``'s, the same cell's graphed learned run
    without the flags, whose work this run repeats before its first
    profile). An ``experiment`` line; returns the launches."""
    from sgs_gnn_tpu_torch.run.cli import config_from_args
    from sgs_gnn_tpu_torch.utils import debug
    cfg = config_from_args(experiment_args("learned", results_dir,
                                           extra=MEMORY_FLAGS))
    check(cfg.gpu_profile and cfg.debug_checks and cfg.hybrid_checkpoint,
          f"memory flags parsed as {cfg}")
    validated, validate = [], debug.validate_graph

    def counted(g, name="graph"):
        validated.append(name)
        return validate(g, name)
    debug.validate_graph = counted
    try:
        res, lines, per_epoch, launches, seconds = run_experiment_counted(
            torch, cfg, ds, "memory flags")
    finally:
        debug.validate_graph = validate
    check(len(validated) == res.plan["parts"],
          f"memory flags: validated {validated}, {res.plan['parts']} parts")
    _check_result("memory flags", res)
    _check_launches("learned", "graphed", launches)
    prof = [ln for ln in lines if ln.startswith("[gpu-profile]")]
    check(len(prof) == len(res.losses),
          f"memory flags: {len(prof)} [gpu-profile] lines in "
          f"{len(res.losses)} epochs")
    segs = []
    for ln in prof:
        fields = dict(kv.split("=", 1) for kv in ln.split()[1:])
        seg = {k: {u: float(fields[f"{k}_{u}"]) for u in ("ms", "mb")}
               for k in SEGMENTS}
        check(all(np.isfinite(v[u]) and v[u] >= 0 for v in seg.values()
                  for u in ("ms", "mb")), f"memory flags: {ln}")
        check(any(v["mb"] > 0 for v in seg.values()),
              f"memory flags: no segment allocated: {ln}")
        segs.append(dict(segments=seg, allocated_mb=float(
            fields["allocated_mb"]), peak_mb=float(fields["peak_mb"])))
    stats = next(ln for ln in lines if ln.startswith("[stats]"))
    # the same work as ``plain`` up to the first profile, then more; 1% for
    # the allocator's rounding (a peak lowered by the resets would be the
    # last segment's, a fraction of it)
    check(res.peak_device_mem_mb >= 0.99 * plain.peak_device_mem_mb,
          f"memory flags: [stats] peak {res.peak_device_mem_mb} MiB below "
          f"the unprofiled run's {plain.peak_device_mem_mb}")
    emit("experiment", mode="learned_memory_flags", route=res.epoch_route,
         flags=list(MEMORY_FLAGS), epoch_s=res.epoch_times,
         eval_ms=[t * 1e3 for t in res.eval_times], run_s=seconds,
         losses=res.losses, gpu_profile=segs, gpu_profile_lines=prof,
         peak_device_mem_mb=res.peak_device_mem_mb,
         unprofiled_peak_device_mem_mb=plain.peak_device_mem_mb,
         stats=stats, launches_per_epoch=per_epoch, launches=launches,
         validated_batches=validated)
    torch.cuda.empty_cache()
    return launches


def phase_quality(torch):
    """tests/test_quality.py's claim on the card: the learned sparsifier
    beats random edges by 0.2 and the full graph by 0.1 in test F1."""
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.data import get_dataset
    from sgs_gnn_tpu_torch.run import driver
    cfg = Config(**QUALITY_KW)
    ds = get_dataset(cfg)
    f1, detail = {}, {}
    for mode in QUALITY_MODES:
        t0 = time.perf_counter()
        (res,) = driver.run_experiment(cfg.replace(mode=mode), ds,
                                       log_fn=lambda *a: None, device=DEVICE)
        _check_result(f"quality {mode}", res)
        f1[mode] = res.final_test_f1
        detail[mode] = dict(run_s=time.perf_counter() - t0,
                            mean_epoch_s=res.mean_epoch_time,
                            final_val_f1=res.final_val_f1,
                            best_test_f1=res.best_test_f1)
    emit("quality", config=QUALITY_KW, he=ds.He, test_f1=f1, detail=detail,
         margins=dict(learned_minus_random=f1["learned"] - f1["random"],
                      learned_minus_full=f1["learned"] - f1["full"]),
         jax_reference=QUALITY_JAX_REFERENCE)
    check(f1["learned"] > f1["random"] + 0.2,
          f"quality: learned {f1['learned']} vs random {f1['random']}")
    check(f1["learned"] > f1["full"] + 0.1,
          f"quality: learned {f1['learned']} vs full {f1['full']}")


# ------------------------------------------------------------ baselines
# tools/baseline_compare.py's widths on the bench partition, f32 as there:
# hidden 64, NeuralSparse's k = max(1, round(0.2 E / N)) edges kept per
# node, SparseGAT's L0 term weighted 1e-3 / E. The card's forward and
# backward are held to the port on the CPU (plain versions) from equal
# parameters: NeuralSparse with one fixed Gumbel draw, SparseGAT with
# deterministic gates. Per-node top-k is a discrete pick (an f32 rounding
# of a score at a node's k-th can swap an edge, which no relative limit
# bounds), so the CPU run takes the card's keep mask, and that mask is held
# bit for bit to the CPU's top-k of the card's scores. Limits (relative
# L2): the f32 layer tests' (tests/test_torch_cuda.py), values 1e-5 and
# gradients 1e-4, ten times each for ~490 edges per node in another order
# (atomics).
BASELINE_HIDDEN = 64
BASELINE_SHARE = 0.2
BASELINE_L0 = 1e-3
BASELINE_STEPS = 5
BASELINE_LR = 0.01
BASELINE_VAL_REL = 1e-4
BASELINE_GRAD_REL = 1e-3
BASELINES = ("neuralsparse", "sparsegat")


def _rel_l2(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def baseline_k():
    """NeuralSparse's edges kept per node (tools/baseline_compare.py)."""
    return max(1, int(round(BASELINE_SHARE * N_EDGES / N_NODES)))


def _baseline_model(torch, name, device):
    from sgs_gnn_tpu_torch.baselines import NeuralSparseGCN, SparseGAT
    gen = torch.Generator().manual_seed(0)
    if name == "neuralsparse":
        return NeuralSparseGCN(FEAT, BASELINE_HIDDEN, CLASSES,
                               k=baseline_k(), device=device, generator=gen)
    return SparseGAT(FEAT, N_EDGES, BASELINE_HIDDEN, CLASSES, device=device,
                     generator=gen)


def _baseline_loss(name, model, t, generator, deterministic):
    """(loss, logits) of one forward: masked CE on the train nodes (+ the
    L0 term for SparseGAT), tools/baseline_compare.py's losses."""
    from sgs_gnn_tpu_torch.train.losses import masked_cross_entropy
    x, s, r, y, train = t
    res = model(x, s, r, generator, deterministic=deterministic)
    logits = res if name == "neuralsparse" else res[0]
    loss = masked_cross_entropy(logits, y, train)
    if name == "sparsegat":
        loss = loss + BASELINE_L0 * res[1] / N_EDGES
    return loss, logits


def _baseline_parity(torch, name, host):
    """One deterministic forward and backward on the card and on the CPU
    (see above): the relative errors, the card's launches, NeuralSparse's
    keep share."""
    from sgs_gnn_tpu_torch.baselines import neuralsparse
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    noise = torch.from_numpy(np.random.default_rng(7).gumbel(size=N_EDGES)
                             .astype(np.float32))
    saved = neuralsparse.gumbel, neuralsparse.per_node_topk_mask
    card = {}

    def card_topk(scores, receivers, n, k):
        card["keep"] = saved[1](scores, receivers, n, k)
        card["scores"] = scores.detach()
        return card["keep"]

    neuralsparse.gumbel = lambda gen, shape, device: noise.to(device)
    out = {}
    try:
        for side, dev in (("card", DEVICE), ("cpu", "cpu")):
            neuralsparse.per_node_topk_mask = (
                card_topk if side == "card"
                else lambda *a: card["keep"].cpu())
            model = _baseline_model(torch, name, dev)
            t = tuple(a.to(dev) for a in host)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            loss, logits = _baseline_loss(name, model, t, None, True)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            out[side] = (float(loss.detach()), logits.detach(),
                         dict(zip(names, grads)), dict(LAUNCHES))
    finally:
        neuralsparse.gumbel, neuralsparse.per_node_topk_mask = saved
    (loss_c, logit_c, grad_c, launches), (loss_f, logit_f, grad_f, _) = (
        out["card"], out["cpu"])
    res = dict(loss_card=loss_c, loss_cpu=loss_f,
               logits_rel_l2=_rel_l2(logit_c, logit_f),
               grad_rel_l2={n: _rel_l2(grad_c[n], g)
                            for n, g in grad_f.items()},
               launches=launches)
    if name == "neuralsparse":
        mask_cpu = saved[1](card["scores"].cpu(), host[2], N_NODES,
                            baseline_k())
        check(torch.equal(mask_cpu, card["keep"].cpu()),
              "neuralsparse: the card's per-node top-k is not the CPU's "
              "on the same scores")
        res["keep_share"] = float(card["keep"].float().mean())
    check(abs(loss_c - loss_f) <= BASELINE_VAL_REL * abs(loss_f)
          and res["logits_rel_l2"] <= BASELINE_VAL_REL,
          f"{name}: card vs cpu loss {loss_c} / {loss_f}, logits "
          f"{res['logits_rel_l2']} (limit {BASELINE_VAL_REL})")
    bad = {n: e for n, e in res["grad_rel_l2"].items()
           if not e <= BASELINE_GRAD_REL}
    check(not bad, f"{name}: gradients off the CPU's {bad} (limit "
                   f"{BASELINE_GRAD_REL})")
    return res


def phase_baselines(torch, arrays):
    """NeuralSparseGCN and SparseGAT on the bench partition (see above):
    the parity step, then Adam steps on the card (one warm-up, one
    launch-counted, BASELINE_STEPS timed; finite losses, peak memory) and
    SparseGAT's kept-edge share (edge_weights > 0). A ``baselines`` line
    each; returns {"baselines <name>": launches of one step}."""
    from sgs_gnn_tpu_torch.baselines import SparseGAT
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    x, edge_index, y, train = arrays
    host = tuple(torch.from_numpy(a) for a in (
        x, edge_index[0], edge_index[1], y, train))
    paths = {}
    for name in BASELINES:
        parity = _baseline_parity(torch, name, host)
        check(parity["launches"].get("scatter_add", 0) > 0
              and parity["launches"].get("segment_sum_scalar", 0) > 0,
              f"{name}: K1 and K2 must run, launched {parity['launches']}")
        model = _baseline_model(torch, name, DEVICE)
        opt = torch.optim.Adam(model.parameters(), lr=BASELINE_LR)
        t = tuple(a.to(DEVICE) for a in host)
        gen = torch.Generator(device=DEVICE).manual_seed(1)

        def step():
            loss, _ = _baseline_loss(name, model, t, gen, False)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

        t0 = time.perf_counter()
        losses = [step()]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        LAUNCHES.clear()
        losses.append(step())
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(BASELINE_STEPS):
            losses.append(step())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / BASELINE_STEPS * 1e3
        losses = torch.stack(losses).cpu()
        check(bool(torch.isfinite(losses).all()),
              f"{name}: losses {losses.tolist()}")
        check(launches.get("scatter_add", 0) > 0
              and launches.get("segment_sum_scalar", 0) > 0,
              f"{name}: step launches {launches}")
        extra = {}
        if name == "sparsegat":
            w = SparseGAT.edge_weights(model.state_dict())
            extra["kept_edge_share"] = float((w > 0).float().mean())
        else:
            extra["k"] = model.k
        emit("baselines", model=name, nodes=N_NODES, edges=N_EDGES,
             features=FEAT, hidden=BASELINE_HIDDEN, classes=CLASSES,
             dtype="float32", lr=BASELINE_LR, l0_lambda=BASELINE_L0,
             losses=losses.tolist(), first_step_ms=first_ms,
             step_ms=step_ms, launches_per_step=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             parity=parity, val_rel_limit=BASELINE_VAL_REL,
             grad_rel_limit=BASELINE_GRAD_REL, **extra)
        paths[f"baselines {name}"] = launches
        del model, opt, t
        torch.cuda.empty_cache()
    return paths


# ----------------------------------------------------------- embeddings
# extract_embeddings at the train phase's width (nhid 256, bf16, one GAT
# head; the GCN scorer, which the drawing does not run) on the bench
# partition's whole edge list. K1 and K2 per first layer: GCN one
# aggregation (K1) and its degrees (K2); GIN one sum (K1); GAT the message
# sum (K1) and the softmax denominators of its (E+N,) logits (K2);
# "logits" runs both layers, twice that. Held to the port on the CPU in
# f32 within the train phase's bf16 limit, GRAD_REL_TOL (relative L2).
EMBEDDING_ROWS = {"GCN": (1, 1), "GIN": (1, 0), "GAT": (1, 1)}


def embedding_launches(gnn, layer):
    k1, k2 = (n * (2 if layer == "logits" else 1)
              for n in EMBEDDING_ROWS[gnn])
    return {k: v for k, v in (("scatter_add", k1),
                              ("segment_sum_scalar", k2)) if v}


def phase_embeddings(torch, arrays):
    """``extract_embeddings`` ('hidden' and 'logits') of GCN, GIN and GAT
    backbones on the card against the CPU f32 port, same weights (see
    above): shapes, finite values, relative L2 within GRAD_REL_TOL, the
    launches of each call held to ``embedding_launches``. An
    ``embeddings`` line each; returns {"embeddings": launches summed}."""
    from sgs_gnn_tpu_torch import Graph, get_model
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    from sgs_gnn_tpu_torch.viz import extract_embeddings
    x, edge_index, y, train = arrays
    graphs = {dev: Graph.build(x, edge_index, y, train, ~train, None,
                               num_classes=CLASSES, device=dev)
              for dev in (DEVICE, "cpu")}
    total = {}
    for gnn in EMBEDDING_ROWS:
        out, ms, launches = {}, {}, {}
        for side, dev, dtype in (("card", DEVICE, "bfloat16"),
                                 ("cpu", "cpu", "float32")):
            model = get_model(gnn, FEAT, NHID, CLASSES, DROP, "GCN",
                              dtype=dtype, device=dev,
                              generator=torch.Generator().manual_seed(0))
            for layer in ("hidden", "logits"):
                torch.cuda.synchronize()
                LAUNCHES.clear()
                t0 = time.perf_counter()
                out[side, layer] = extract_embeddings(model, graphs[dev],
                                                      layer)
                if side == "card":
                    ms[layer] = (time.perf_counter() - t0) * 1e3
                    launches[layer] = dict(LAUNCHES)
        err = {}
        for layer, width in (("hidden", NHID), ("logits", CLASSES)):
            card, cpu = (torch.from_numpy(out[side, layer])
                         for side in ("card", "cpu"))
            check(card.shape == (N_NODES, width)
                  and bool(torch.isfinite(card).all()),
                  f"embeddings {gnn} {layer}: shape {tuple(card.shape)}")
            err[layer] = _rel_l2(card, cpu)
            check(launches[layer] == embedding_launches(gnn, layer),
                  f"embeddings {gnn} {layer}: launches {launches[layer]}, "
                  f"expected {embedding_launches(gnn, layer)}")
            for k, v in launches[layer].items():
                total[k] = total.get(k, 0) + v
        emit("embeddings", model=f"{gnn}+GCN", nodes=N_NODES, edges=N_EDGES,
             nhid=NHID, dtype="bfloat16", call_ms=ms, launches=launches,
             rel_l2_vs_cpu_f32=err, limit=GRAD_REL_TOL)
        check(max(err.values()) <= GRAD_REL_TOL,
              f"embeddings {gnn}: card bf16 vs cpu f32 {err} (limit "
              f"{GRAD_REL_TOL})")
    del graphs
    torch.cuda.empty_cache()
    return {"embeddings": total}


# ------------------------------------------------------ tensor parallel
# shard_params_tp on the one-rank NCCL group phase_parallel started
# (make_dp_tp_mesh(1, 1): every shard whole, every collective an
# identity), on the bench partition without a tile index (the sharded head
# refuses K6), bench.py's hybrid_rescore flags. The sharded head runs
# unfused: its detached pass over every edge and its pass on the q winners
# gather both endpoints, whose backward is K1 on each side, in place of K3
# (twice) and K5. So one step launches K1 4 (scorer encoder) + 2 (the
# head's gathers) + 8 (learned and random backbones) + 2 (reg2) = 16 and
# K2 6, and no head kernel. Parity: one step against the sequential step
# from equal parameters, sample frozen (the two heads' probabilities
# differ by bf16 roundings, which would move Gumbel top-k picks), dropout
# and the conditional gate off (every parameter gets a gradient; the
# fused head's hash32 mask and the unfused head's generator mask are other
# draws); limits the grad_check's bf16 ones (1% on the loss, GRAD_REL_TOL
# per gradient), since the unfused head rounds to bf16 where K3 and K5
# keep f32 (ROADMAP §3), with a second sequential copy's gap beside them.
TP_LAUNCHES = {"scatter_add": 16, "segment_sum_scalar": 6}
TP_HEAD_KERNELS = ("score_head_sampled", "score_head_sampled_banded",
                   "score_head_bwd", "score_head_tiles")
TP_LOSS_RTOL = 1e-2
TP_STEPS = 5


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_tensor_parallel(torch, arrays):
    """Hidden-dimension TP at tp = 1 on the card (see above): the parity
    step, a launch-counted TP step under no_host_sync held to TP_LAUNCHES
    (no head kernel), the TP and sequential steps with bench.py's dropout
    timed in turns, profiled, with their peaks. A ``tensor_parallel``
    line; returns {"tensor_parallel_step": launches}."""
    from sgs_gnn_tpu_torch import (Config, DualOptimizer, Graph,
                                   make_train_step)
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    from sgs_gnn_tpu_torch.parallel import (backend_for, make_dp_tp_mesh,
                                            shard_params_tp)
    from sgs_gnn_tpu_torch.train import pipelines
    mesh = make_dp_tp_mesh(1, 1)
    check((mesh.dp, mesh.tp, mesh.backend) == (1, 1, backend_for(DEVICE)),
          f"tensor-parallel mesh {mesh}")
    x, edge_index, y, train = arrays
    g = Graph.build(x, edge_index, y, train, ~train, None, device=DEVICE,
                    prob=degree_prior(edge_index[0], edge_index[1], N_NODES),
                    num_classes=CLASSES, sort_by_receiver=True,
                    tile_index=False)
    check(g.tile_t == 0 and g.receiver_band > 0, "graph layout")

    def models(cfg, n, sharded):
        out = []
        for i in range(n):
            m, opt = _fresh_model(torch, cfg, FEAT, CLASSES)
            if sharded[i]:
                shard_params_tp(m, mesh)
                opt = DualOptimizer.create(m, cfg.GNN, cfg.lr,
                                           cfg.weight_decay)
            out.append((m, opt, make_train_step(cfg, m, opt, Q, 40)))
        return out

    cfg_p = Config(**dict(bench_config(pipeline="hybrid", drop_rate=0.0),
                          conditional=False))
    (m_seq, o_seq, seq), (_, o_ref, ref), (m_tp, o_tp, tp) = models(
        cfg_p, 3, (False, False, True))
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.sort(rng.choice(
        np.flatnonzero(g.edge_mask.cpu().numpy()), Q, replace=False))
        .astype(np.int32))
    rand_idx = torch.from_numpy(rng.choice(N_EDGES, Q, replace=False)
                                .astype(np.int32))
    gen = torch.Generator(device=DEVICE)
    restore = _frozen_sampling(torch, pipelines, idx, rand_idx)
    try:
        with _captured_grads((o_seq, o_ref, o_tp), "step_learned") as grads:
            losses = [float(step(g, 0, gen.manual_seed(5)).loss)
                      for step in (seq, ref, tp)]
    finally:
        restore()
    grad_gap = _grad_gaps(o_seq.names, grads[2], grads[0])
    grad_floor = _grad_gaps(o_seq.names, grads[1], grads[0])
    loss_rel = abs(losses[2] - losses[0]) / abs(losses[0])
    del grads, m_seq, o_seq, seq, o_ref, ref, m_tp, o_tp, tp
    gc.collect()
    torch.cuda.empty_cache()

    cfg = Config(**bench_config(pipeline="hybrid"))
    check(cfg.drop_rate == DROP, f"drop_rate {cfg.drop_rate}")
    (m_seq, _, seq), (m_tp, _, tp) = models(cfg, 2, (False, True))
    seq(g, 0, gen.manual_seed(6))
    tp(g, 0, gen.manual_seed(6))
    torch.cuda.synchronize()
    LAUNCHES.clear()
    seq(g, 1, gen.manual_seed(7))
    torch.cuda.synchronize()
    seq_launches = dict(LAUNCHES)
    LAUNCHES.clear()
    with no_host_sync(torch):
        tp(g, 1, gen.manual_seed(7))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peaks = {}
    for name, step in (("sequential", seq), ("tensor_parallel", tp)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(g, 2, gen.manual_seed(8))
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    times = _turns(torch, {
        "sequential": lambda i: seq(g, 3 + i, gen.manual_seed(100 + i)),
        "tensor_parallel": lambda i: tp(g, 3 + i, gen.manual_seed(100 + i))},
        TP_STEPS)
    prof = {"sequential": profile_breakdown(
                torch, lambda: seq(g, 20, gen.manual_seed(200))),
            "tensor_parallel": profile_breakdown(
                torch, lambda: tp(g, 20, gen.manual_seed(200)))}
    emit("tensor_parallel", pipeline="hybrid_rescore", dp=mesh.dp,
         tp=mesh.tp, backend=mesh.backend, nvidia_smi=card_line(),
         config=bench_config(pipeline="hybrid"), tile_index=False,
         nodes=N_NODES, edges=N_EDGES, features=FEAT, nhid=NHID, q=Q,
         parity=dict(losses=dict(zip(("sequential", "sequential_copy",
                                      "tensor_parallel"), losses)),
                     loss_rel=loss_rel, loss_rtol=TP_LOSS_RTOL,
                     grad_rel_l2=grad_gap,
                     grad_rel_l2_max=max(grad_gap.values()),
                     grad_rel_l2_copy_max=max(grad_floor.values()),
                     grad_rel_limit=GRAD_REL_TOL,
                     note="sample frozen, dropout and gate off"),
         launches_per_step=launches, sequential_launches=seq_launches,
         step_ms=times, max_memory_allocated=peaks,
         device_busy_ms={k: v["device_busy_ms"] for k, v in prof.items()},
         idle_share={k: v["idle_share"] for k, v in prof.items()})
    for k, v in prof.items():
        emit("profile", call=f"{k} step (no tile index)", **v)
    check(not any(k in launches for k in TP_HEAD_KERNELS),
          f"tensor-parallel step launched a fused head kernel: {launches}")
    check(launches == TP_LAUNCHES, f"tensor-parallel step launches "
                                   f"{launches}, expected {TP_LAUNCHES}")
    check(loss_rel <= TP_LOSS_RTOL, f"tensor parallel at tp 1: losses "
                                    f"{losses} (limit {TP_LOSS_RTOL})")
    bad = {n: e for n, e in grad_gap.items() if not e <= GRAD_REL_TOL}
    check(not bad, f"tensor parallel at tp 1: gradients {bad} (limit "
                   f"{GRAD_REL_TOL}; a second sequential copy "
                   f"{max(grad_floor.values())})")
    del m_seq, seq, m_tp, tp, g
    gc.collect()
    torch.cuda.empty_cache()
    return {"tensor_parallel_step": launches}


# one entry per TPU kernel of the JAX package (each function that reaches
# pl.pallas_call): the port's kernel name, its source and what it replaces
KERNELS = {
    "scatter_add": ("sgs_gnn_tpu_torch/csrc/scatter.cu",
                    "sgs_gnn_tpu/ops/scatter_pallas.py:197"),
    "segment_sum_scalar": ("sgs_gnn_tpu_torch/csrc/segment_sum.cu",
                           "sgs_gnn_tpu/ops/scatter_pallas.py:265"),
    # row 3, call_full of _make_fwd_kernel
    "score_head_sampled": ("sgs_gnn_tpu_torch/csrc/head_mma.cuh",
                           "sgs_gnn_tpu/ops/score_sampled.py:127"),
    # row 4, call_banded: the same kernel with a sorted side
    "score_head_sampled_banded": ("sgs_gnn_tpu_torch/csrc/head_mma.cuh",
                                  "sgs_gnn_tpu/ops/score_sampled.py:368"),
    # row 5, full and banded
    "score_head_bwd": ("sgs_gnn_tpu_torch/csrc/head_bwd_mma.cuh",
                       "sgs_gnn_tpu/ops/score_sampled.py:184"),
    "score_head_tiles": ("sgs_gnn_tpu_torch/csrc/head_mma.cuh",
                         "sgs_gnn_tpu/ops/score_tiles.py:115"),
    "scatter_add_sorted": ("sgs_gnn_tpu_torch/csrc/scatter_sorted.cu",
                           "sgs_gnn_tpu/ops/scatter_pallas.py:109"),
    "spmm_fused": ("sgs_gnn_tpu_torch/csrc/spmm.cu",
                   "sgs_gnn_tpu/ops/spmm_pallas.py:42"),
}
# the bf16 head (csrc/head_mma.cuh: rows 3, 4 and 6; csrc/head_bwd_mma.cuh:
# row 5) and K8's tile route (row 8, its main case)
TENSOR_CORE = ("score_head_sampled", "score_head_sampled_banded",
               "score_head_bwd", "score_head_tiles", "spmm_fused")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port itself: without it (this script alone) fail before printing
    from sgs_gnn_tpu_torch import Graph
    from sgs_gnn_tpu_torch.data import degree_prior
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_sass(torch)

    arrays = build_partition()
    x, edge_index, y, train = arrays
    g = Graph.build(x, edge_index, y, train, ~train, None, device=DEVICE,
                    prob=degree_prior(edge_index[0], edge_index[1], N_NODES),
                    sort_by_receiver=True, tile_index=True)
    kernels = phase_kernels(torch, g)
    phase_head_kernels(torch, g, kernels)
    phase_sparse_kernels(torch, g, kernels)
    paths = {"fused_spmm": phase_fused_spmm(torch, g)}
    del g
    torch.cuda.empty_cache()
    paths["serve"] = phase_serve(torch, arrays)
    g = train_graph(torch, arrays)
    paths.update(phase_train(torch, arrays, g))
    paths.update(phase_models(torch, arrays, g))
    paths.update(phase_dense(torch, g, kernels, paths))
    del g
    torch.cuda.empty_cache()
    paths.update(phase_experiment(torch))
    phase_quality(torch)
    paths.update(phase_baselines(torch, arrays))
    paths.update(phase_embeddings(torch, arrays))
    # last, so that no earlier measurement runs beside the process group
    # or what its phases leave on the card
    g = train_graph(torch, arrays)
    paths.update(phase_parallel(torch, g))
    del g
    torch.cuda.empty_cache()
    paths.update(phase_tensor_parallel(torch, arrays))
    with tempfile.TemporaryDirectory() as results_dir:
        paths.update(phase_parallel_experiment(torch, experiment_dataset(),
                                               results_dir))

    line = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]          # its case at the main path's shapes
        by_path = {p: n.get(name, 0) for p, n in paths.items()}
        check(any(by_path.values()), f"{name}: launched on no path")
        line.append(dict(
            name=name, route="cuda",
            units=("tensor cores (wgmma, bf16)" if name in TENSOR_CORE
                   else "CUDA cores"),
            source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            device_ms=k["device_ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], bound_share=k["bound_ms"] / k["ms"],
            device_bound_share=k["bound_ms"] / k["device_ms"],
            library_ms=k["library_ms"], matched=True, case=k["case"]))
    print(json.dumps({"kernels": line}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

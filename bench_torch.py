#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: hybrid-pipeline training
throughput on a Reddit-scale cluster partition, on one NVIDIA card.

    python3 bench_torch.py [--hybrid_checkpoint] [--sorted_head_off]
                           [--steps N]

The torch twin of ``bench.py``: the same partition (N=2048 nodes, E=1M
directed edges with power-law degrees, 602 features, 41 classes,
receiver-sorted, degree prior, tile index), the same configuration
(learned hybrid with hybrid_rescore, conditional, sparse_edge_mlp, reg1,
reg2, GCN backbone and scorer, nhid 256, bf16, q=200k) and the same metric:
edges per second = E / mean step time, against the reference's 8.05e6
edges/s (``bench.py``'s REFERENCE_EDGES_PER_S). One step is one cluster
batch's update.

The step is timed two ways on the same model, in turns (graphed, eager,
eager, graphed; ``--steps`` steps per block, host clock ending in a
synchronize): as a CUDA graph replay (``make_scan_epoch_step`` over this
one batch, the route ``scan_epoch=auto`` takes on a partitioned run) and
as the eager step (``make_train_step``, the per-batch loop). Prints the
card's name and power limit (nvidia-smi), then ONE JSON line:
{"metric", "value" (graphed), "unit", "vs_baseline", "eager_value",
"eager_vs_baseline", "step_ms", "eager_step_ms", "device", "power_limit"}.
Exits 1 without a card.
"""
import json
import subprocess
import sys
import time

import numpy as np

REFERENCE_EDGES_PER_S = 114_615_892 / 14.24  # ~8.05e6, as bench.py
Q = 200_000          # metis_threshold 1M * sample_perc 0.2
DEVICE = "cuda"      # the card (a CPU rehearsal sets "cpu")


def build_partition(torch, n_nodes=2048, n_edges=1_000_000, feat=602,
                    classes=41, seed=0):
    """bench.py's partition, as a port Graph on the card."""
    from sgs_gnn_tpu_torch import Graph
    from sgs_gnn_tpu_torch.data import degree_prior
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.5, n_nodes) + 1.0
    p = w / w.sum()
    senders = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    receivers = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    x = rng.normal(size=(n_nodes, feat)).astype(np.float32)
    y = rng.integers(0, classes, n_nodes).astype(np.int32)
    train = rng.random(n_nodes) < 0.66
    prob = degree_prior(senders, receivers, n_nodes)
    return Graph.build(x, np.stack([senders, receivers]), y, train, ~train,
                       np.zeros(n_nodes, bool), prob=prob,
                       num_classes=classes, sort_by_receiver=True,
                       tile_index=True, device=DEVICE)


def card_line():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    remat = "--hybrid_checkpoint" in argv
    sorted_head = "off" if "--sorted_head_off" in argv else "auto"
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 20
    from sgs_gnn_tpu_torch import (Config, DualOptimizer, get_model,
                                   make_train_step)
    from sgs_gnn_tpu_torch.run.driver import batch_seed
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)

    g = build_partition(torch)
    cfg = Config(pipeline="hybrid", mode="learned", conditional=True,
                 sparse_edge_mlp=True, reg1=True, reg2=True,
                 hybrid_checkpoint=remat, sorted_head=sorted_head,
                 nhid=256, dtype="bfloat16")
    model = get_model(cfg.GNN, g.x.shape[1], cfg.nhid, g.num_classes,
                      cfg.drop_rate, cfg.edge_mlp_type, dtype=cfg.dtype,
                      device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    opt = DualOptimizer.create(model, cfg.GNN, cfg.lr, cfg.weight_decay)
    max_epoch = 4 * steps + 4
    eager_step = make_train_step(cfg, model, opt, Q, max_epoch)
    epoch_step = make_scan_epoch_step(cfg, model, opt, Q, max_epoch, 1)
    gen = torch.Generator(device=DEVICE)
    counter = iter(range(1, 10 ** 9))

    def graphed():
        epoch = next(counter)
        return epoch_step([g], [0], [2], epoch, gen,
                          lambda n: batch_seed(1, 0, n))[0].clone()

    def eager():
        epoch = next(counter)
        gen.manual_seed(batch_seed(1, 0, epoch + 1))
        return eager_step(g, epoch, gen).loss

    # warm-up: the kernels built, the graph captured after its eager step
    for fn in (eager, graphed):
        float(fn())

    def block(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [fn() for _ in range(steps)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        final = float(torch.stack(losses).sum())
        if not np.isfinite(final):
            raise RuntimeError(f"non-finite losses: {final}")
        return dt

    times = {"graphed": [], "eager": []}
    for name in ("graphed", "eager", "eager", "graphed"):
        times[name].append(block(graphed if name == "graphed" else eager))
    step_s = {k: float(np.mean(v)) for k, v in times.items()}
    eps = {k: g.num_edges / v for k, v in step_s.items()}
    name, _, limit = card.partition(", ")
    print(json.dumps({
        "metric": "hybrid_train_edges_per_s" + ("_remat" if remat else ""),
        "value": round(eps["graphed"], 1),
        "unit": "edges/s",
        "vs_baseline": round(eps["graphed"] / REFERENCE_EDGES_PER_S, 4),
        "eager_value": round(eps["eager"], 1),
        "eager_vs_baseline": round(eps["eager"] / REFERENCE_EDGES_PER_S, 4),
        "step_ms": step_s["graphed"] * 1e3,
        "eager_step_ms": step_s["eager"] * 1e3,
        "block_ms": {k: [t * 1e3 for t in v] for k, v in times.items()},
        "device": name or torch.cuda.get_device_name(0),
        "power_limit": limit,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

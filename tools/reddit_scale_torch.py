#!/usr/bin/env python3
"""The port's twin of Scripts/run_reddit_scale.sh and
Scripts/run_reddit_modes.sh, on one NVIDIA card.

    python3 tools/reddit_scale_torch.py                # the seven runs
    python3 tools/reddit_scale_torch.py --host-only [--root DIR]

The runs, each through the port's CLI parser with the scripts' flags and
``run_experiment`` (the graphed route, ``scan_epoch=auto``):
  0. run_reddit_scale.sh: learned on SyntheticReddit, 16 epochs, as
     logs/reddit_scale_tpu.log;
  1-3. run_reddit_modes.sh: random, edge and full on SyntheticReddit;
  4-6. run_reddit_modes.sh: learned, random and full on
     SyntheticRedditLow (the sparsifier's separation claim),
each of 1-6 for 40 epochs, as its JAX log (``Iteration:  40``). Each
dataset is generated once and the same ``HostDataset`` goes to every mode.
One JSON line per run: the plan, the host seconds of its set-up by stage,
epoch and eval times, steady edges/s, peak memory, losses and F1s beside
the JAX package's F1 from its log (the reference's quality, not a number
of the port).

``--host-only`` runs the set-up of run 0 alone (generation, get_dataset,
partition, induced subgraphs with the tile index, the copy to the card)
and prints one ``host_stages`` line with the host peak RSS; ``--root DIR``
takes the port from the checkout at DIR (for instance the parent commit,
unpacked by ``git archive``), so the same stages of two commits can be
timed in turns on one machine. Without a card it exits 1.

The scripts' flags, ``HostStages`` and the plan's reading are
chip_smoke.py's, which runs run 0 for three epochs as its ``reddit_scale``
phase.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402

# (script, dataset, mode, epochs, the JAX package's final test F1, its log)
RUNS = (
    ("run_reddit_scale.sh", "SyntheticReddit", "learned", 16, 0.9522,
     "logs/reddit_scale_tpu.log:37"),
    ("run_reddit_modes.sh", "SyntheticReddit", "random", 40, 0.9509,
     "logs/reddit_scale_mode_random_tpu.log:43"),
    ("run_reddit_modes.sh", "SyntheticReddit", "edge", 40, 0.9509,
     "logs/reddit_scale_mode_edge_tpu.log:45"),
    ("run_reddit_modes.sh", "SyntheticReddit", "full", 40, 0.9508,
     "logs/reddit_scale_mode_full_tpu.log:37"),
    ("run_reddit_modes.sh", "SyntheticRedditLow", "learned", 40, 0.9158,
     "logs/redditlow_scale_mode_learned_tpu.log:45"),
    ("run_reddit_modes.sh", "SyntheticRedditLow", "random", 40, 0.2800,
     "logs/redditlow_scale_mode_random_tpu.log:44"),
    ("run_reddit_modes.sh", "SyntheticRedditLow", "full", 40, 0.3862,
     "logs/redditlow_scale_mode_full_tpu.log:46"),
)


def load_dataset(torch, cfg):
    """get_dataset(cfg) under HostStages: (dataset, its stages, seconds)."""
    from sgs_gnn_tpu_torch.data import registry
    with cs.HostStages(torch) as st:
        t0 = time.perf_counter()
        ds = registry.get_dataset(cfg)
        seconds = time.perf_counter() - t0
    return ds, st, seconds


def host_only(torch):
    """Run 0's set-up alone: a ``host_stages`` line."""
    from sgs_gnn_tpu_torch.run import driver
    reset = cs.reset_peak_rss()
    cfg = cs.reddit_config(*RUNS[0][1:4])
    ds, st, dataset_s = load_dataset(torch, cfg)
    with cs.HostStages(torch) as pb:
        batches, q, partitioner = driver.prepare_batches(cfg, ds, "cuda")
    stages = {**st.seconds, **pb.seconds}
    pb.seconds = stages
    line = dict(phase="host_stages", root=str(port_root()),
                dataset=cfg.dataset, nodes=ds.num_nodes,
                edges=ds.num_edges, parts=len(batches), q=q,
                partitioner=partitioner,
                shape_classes=sorted({g.num_edges for g in batches},
                                     reverse=True),
                host_s=pb.summary(dataset_s), dataset_s=dataset_s,
                batch_gb=pb.batch_bytes / 1e9,
                host_peak_rss_gb=cs.rss_gb(),
                host_peak_rss_reset=reset, **cs.plan_of(batches))
    print(json.dumps(line), flush=True)


def port_root() -> Path:
    import sgs_gnn_tpu_torch
    return Path(sgs_gnn_tpu_torch.__file__).resolve().parents[1]


def one_run(torch, idx, ds):
    from sgs_gnn_tpu_torch.run import driver
    script, dataset, mode, epochs, jax_f1, jax_log = RUNS[idx]
    cfg = cs.reddit_config(dataset, mode, epochs)
    lines = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cs.HostStages(torch) as st:
        (res,) = driver.run_experiment(cfg, ds, log_fn=lines.append,
                                       device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    plan = res.plan
    line = dict(
        phase="reddit_run", run=idx, script=script, dataset=dataset,
        mode=mode, epochs=epochs, nodes=ds.num_nodes, edges=ds.num_edges,
        he=ds.He, parts=plan["parts"], q=plan["q"],
        partitioner=plan["partitioner"],
        shape_classes=plan["shape_classes"],
        valid_edges=plan["valid_edges"], route=res.epoch_route,
        graphs=res.graphs, **cs.plan_of(st.batches),
        prepare_s=dict(partition=st.seconds.get("partition", 0.0),
                       subgraphs=st.seconds.get("subgraphs", 0.0)
                       - st.seconds.get("copy", 0.0),
                       copy=st.seconds.get("copy", 0.0)),
        epoch_s=res.epoch_times, eval_ms=[t * 1e3 for t in res.eval_times],
        edges_per_s_steady=res.edges_per_s_steady,
        peak_device_mem_mb=res.peak_device_mem_mb,
        peak_reserved_mb=torch.cuda.max_memory_reserved() / 2 ** 20,
        losses=res.losses, test_curve=res.test_curve,
        final_f1=dict(train=res.final_train_f1, val=res.final_val_f1,
                      test=res.final_test_f1),
        best_val_f1=res.best_val_f1, run_s=run_s,
        jax_final_test_f1=jax_f1, jax_log=jax_log,
        stats=next((ln for ln in lines if ln.startswith("[stats]")), ""))
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host-only", action="store_true",
                   help="time run 0's set-up alone")
    p.add_argument("--root", default=None,
                   help="take sgs_gnn_tpu_torch from this checkout")
    args = p.parse_args(argv)
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("reddit_scale_torch: no CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(dict(card=torch.cuda.get_device_name(0),
                          nvidia_smi=cs.card_line())), flush=True)
    if args.host_only:
        host_only(torch)
        return 0
    from sgs_gnn_tpu_torch.data import registry
    datasets = {}
    for idx in range(len(RUNS)):
        dataset = RUNS[idx][1]
        if dataset not in datasets:
            datasets.clear()          # one dataset on the host at a time
            cfg = cs.reddit_config(*RUNS[idx][1:4])
            t0 = time.perf_counter()
            datasets[dataset] = registry.get_dataset(cfg)
            print(json.dumps(dict(phase="dataset", dataset=dataset,
                                  seconds=time.perf_counter() - t0)),
                  flush=True)
        one_run(torch, idx, datasets[dataset])
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface (port of ``run/cli.py``), flag-compatible with
the JAX package's parser and so with the reference's (reference
parser.py:60-109): the same option strings, dests and defaults, except
``--device`` (the port's device, default ``cuda``; ``cuda:<i>`` accepted)
and ``--platform`` (``cpu`` is an alias for ``--device cpu``); any other
device or platform raises. There is no compilation cache.

    python -m sgs_gnn_tpu_torch.run.cli --dataset Karate --device cpu ...

is the counterpart of ``python -m sgs_gnn_tpu.run.cli`` (and of the
reference's ``python main.py``). The multi-rank paths run one process per
rank, for instance two CPU ranks talking gloo:

    torchrun --nproc_per_node 2 -m sgs_gnn_tpu_torch.run.cli --device cpu \
        --data_parallel on --dataset SyntheticSBM --metis_threshold 2000

(on cards each rank binds ``cuda:LOCAL_RANK`` and talks NCCL); without
``torchrun`` or ``--multihost --coordinator_address host:port
--num_processes W --process_id r`` they run as a one-rank group.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..core.config import Config, DATASETS, GNNS, EDGE_MLPS, PIPELINES, MODES


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(prog="sgs-gnn-tpu-torch")
    p.add_argument('--GNN', type=str, default=d.GNN, choices=GNNS)
    p.add_argument('--edge_mlp_type', type=str, default=d.edge_mlp_type,
                   choices=EDGE_MLPS)
    p.add_argument('--sparse_edge_mlp', type=str2bool, nargs='?', const=False,
                   default=d.sparse_edge_mlp)
    p.add_argument('--conditional', type=str2bool, nargs='?', const=True,
                   default=d.conditional)
    p.add_argument('--eval', type=str2bool, nargs='?', const=True,
                   default=d.eval)
    p.add_argument('--runs', type=int, default=d.runs)
    p.add_argument('--seed', type=int, default=d.seed)
    # no argparse `choices`: names outside DATASETS are admitted when a
    # converted npz or vendored directory exists (the reference's
    # notebook-only datasets — OGB_MAG, Reddit2 — enter this way);
    # Config.validate() rejects everything else with the full list
    p.add_argument('--dataset', type=str, default=d.dataset)
    p.add_argument('--mode', type=str, default=d.mode, choices=MODES)
    p.add_argument('--lr', type=float, default=d.lr)
    p.add_argument('--drop_rate', type=float, default=d.drop_rate)
    p.add_argument('--weight_decay', type=float, default=d.weight_decay)
    p.add_argument('--epochs', type=int, default=200)
    p.add_argument('--sample_perc', type=float, default=d.sample_perc)
    p.add_argument('--metis_threshold', type=int, default=d.metis_threshold)
    p.add_argument('--t_init', type=float, default=d.t_init)
    p.add_argument('--t_min', type=float, default=d.t_min)
    p.add_argument('--regularizer1_coef', type=float,
                   default=d.regularizer1_coef)
    p.add_argument('--reg1', type=str2bool, nargs='?', const=True,
                   default=d.reg1)
    p.add_argument('--reg2', type=str2bool, nargs='?', const=True,
                   default=d.reg2)
    p.add_argument('--consist_reg_coef', type=float,
                   default=d.consist_reg_coef)
    p.add_argument('--degree_bias_coef', type=float,
                   default=d.degree_bias_coef)
    p.add_argument('--nhid', type=int, default=d.nhid)
    p.add_argument('--num_samples_eval', type=int, default=d.num_samples_eval)
    p.add_argument('--device', type=str, default='cuda',
                   help="the port's device: 'cuda' (or 'cuda:<i>') or "
                        "'cpu'")
    p.add_argument('--save_csv', type=str2bool, nargs='?', const=True,
                   default=d.save_csv)
    p.add_argument('--plot_curve', type=str2bool, nargs='?', const=False,
                   default=d.plot_curve)
    p.add_argument('--log', type=str2bool, nargs='?', const=False,
                   default=d.log)
    p.add_argument('--convergence', type=float, default=d.convergence)
    p.add_argument('--ER', type=str2bool, nargs='?', const=False,
                   default=d.ER)
    p.add_argument('--ERcompute', type=str2bool, nargs='?', const=False,
                   default=d.ERcompute)
    p.add_argument('--syn', type=str2bool, nargs='?', const=False,
                   default=d.syn)
    p.add_argument('--degree', type=int, default=d.degree)
    p.add_argument('--train', type=float, default=d.train)
    p.add_argument('--hn', type=float, default=d.hn)
    p.add_argument('--pipeline', type=str, default='two_pass',
                   choices=PIPELINES)
    p.add_argument('--gpu_profile', type=str2bool, nargs='?', const=True,
                   default=d.gpu_profile)
    p.add_argument('--stats', type=str2bool, nargs='?', const=True,
                   default=d.stats)
    p.add_argument('--hybrid_checkpoint', type=str2bool, nargs='?',
                   const=True, default=d.hybrid_checkpoint)
    p.add_argument('--hybrid_rescore', type=str2bool, nargs='?',
                   const=True, default=d.hybrid_rescore,
                   help='hybrid fast path: backward over sampled edges only')
    # framework-specific extras
    p.add_argument('--data_dir', type=str, default=d.data_dir)
    p.add_argument('--results_dir', type=str, default=d.results_dir)
    p.add_argument('--gat_heads', type=int, default=d.gat_heads)
    p.add_argument('--num_partitions', type=int, default=d.num_partitions)
    p.add_argument('--dtype', type=str, default=d.dtype,
                   choices=['float32', 'bfloat16'])
    p.add_argument('--prng_impl', type=str, default=d.prng_impl,
                   choices=['threefry2x32', 'rbg'])
    p.add_argument('--approx_topk', type=str2bool, nargs='?', const=True,
                   default=d.approx_topk)
    p.add_argument('--topk_bf16', type=str2bool, nargs='?', const=True,
                   default=d.topk_bf16,
                   help='bf16 Gumbel keys inside approx top-k sampling '
                        '(TPU only; see Config.topk_bf16)')
    p.add_argument('--checkpoint_every', type=int, default=d.checkpoint_every)
    p.add_argument('--resume', type=str2bool, nargs='?', const=True,
                   default=d.resume)
    p.add_argument('--debug_checks', type=str2bool, nargs='?', const=True,
                   default=d.debug_checks)
    p.add_argument('--data_parallel', type=str, default=d.data_parallel,
                   choices=['off', 'on'])
    p.add_argument('--halo', type=str2bool, nargs='?', const=True,
                   default=d.halo,
                   help='halo-exchange mode: full-graph semantics with '
                        'partitioned storage over the ranks')
    p.add_argument('--dense_subgraph', type=str, default=d.dense_subgraph,
                   choices=['auto', 'on', 'off'],
                   help='densify per-step subgraphs into (N,N) adjacencies '
                        '(MXU matmuls instead of gather/scatter)')
    p.add_argument('--dense_threshold', type=int, default=d.dense_threshold)
    p.add_argument('--shape_classes', type=int, default=d.shape_classes,
                   help='padded edge-shape classes for partition batches '
                        '(1 = single global pad shape)')
    p.add_argument('--scan_epoch', type=str, default=d.scan_epoch,
                   help="'auto' runs whole epochs as one device-side scan "
                        "over stacked cluster batches when eligible; 'off' "
                        "keeps the per-batch dispatch loop")
    p.add_argument('--tile_index', type=str, default=d.tile_index,
                   choices=['auto', 'on', 'off'],
                   help='fused tile-pair score kernel for the hybrid '
                        'sampling pass (auto = TPU only)')
    p.add_argument('--sorted_head', type=str, default=d.sorted_head,
                   choices=['auto', 'off'],
                   help='sort sampled indices so the fused sampled-edge '
                        'head runs banded one-hot ops (A/B: off)')
    p.add_argument('--multihost', type=str2bool, nargs='?', const=True,
                   default=d.multihost,
                   help='start the process group from --coordinator_'
                        'address/--num_processes/--process_id (or '
                        "torchrun's environment) and run over every rank")
    p.add_argument('--coordinator_address', type=str,
                   default=d.coordinator_address)
    p.add_argument('--num_processes', type=int, default=d.num_processes)
    p.add_argument('--process_id', type=int, default=d.process_id)
    p.add_argument('--platform', type=str, default='',
                   help="'cpu' is an alias for --device cpu; empty = "
                        "--device decides")
    return p


def config_from_args(argv=None) -> Config:
    args, _ = build_parser().parse_known_args(argv)
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    return Config(**kw)


def device_from_args(args) -> str:
    """The device of ``--device`` / ``--platform``; raises on any other."""
    if args.platform not in ("", "cpu"):
        raise ValueError(f"--platform {args.platform!r}: the port runs on "
                         "'cpu' (alias of --device cpu) or, by default, on "
                         "--device")
    device = "cpu" if args.platform == "cpu" else args.device
    if device != "cpu" and device.split(":")[0] != "cuda":
        raise ValueError(f"--device {device!r}: the port runs on 'cuda', "
                         "'cuda:<i>' or 'cpu'")
    return device


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    device = device_from_args(args)
    cfg = config_from_args(argv)
    print(cfg.dataset)
    from .driver import run_experiment
    run_experiment(cfg, device=device)


if __name__ == "__main__":
    main()

"""Experiment configuration, flag-identical to the JAX package's ``Config``.

The port keeps its own copy (it imports nothing of ``sgs_gnn_tpu``): the
same frozen dataclass, the same names and defaults, the same ``validate``.
Fields that select TPU-only mechanisms (``prng_impl``, ``approx_topk``,
``topk_bf16``, ``dense_subgraph``, ``tile_index``, ``scan_epoch``,
``sorted_head``) are kept so that configurations stay interchangeable; the
serving slice of the port reads ``degree_bias_coef``, ``num_samples_eval``,
``mode``, ``nhid``, ``drop_rate``, ``GNN``, ``edge_mlp_type`` and ``dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

DATASETS = [
    'Cornell', 'Texas', 'Wisconsin', 'reed98', 'amherst41', 'penn94',
    'Roman-empire', 'cornell5', 'Squirrel', 'johnshopkins55', 'Actor',
    'Minesweeper', 'Questions', 'Chameleon', 'Tolokers', 'Amazon-ratings',
    'genius', 'pokec', 'arxiv-year', 'snap-patents', 'Cora', 'DBLP',
    'Computers', 'PubMed', 'Cora_ML', 'SmallCora', 'CS', 'Photo', 'Physics',
    'CiteSeer', 'wiki', 'Reddit', 'ogbn-proteins', 'Reddit0.1', 'Reddit0.2',
    'Reddit0.3', 'Reddit0.4', 'Reddit0.5', 'Reddit0.6', 'Reddit0.7', 'Moon',
    'Karate',
    # new in this framework: synthetic fixtures usable without downloads
    'SyntheticSBM', 'SyntheticLarge', 'SyntheticSBMLow', 'SyntheticReddit',
    'SyntheticRedditLow',
]

GNNS = ['GCN', 'GIN', 'GAT', 'Cheb']
EDGE_MLPS = ['MLP', 'GSAGE', 'GCN']
PIPELINES = ['two_pass', 'straight_through', 'hybrid']
MODES = ['learned', 'edge', 'random', 'full']


@dataclasses.dataclass(frozen=True)
class Config:
    # model (reference parser.py:62-63, 85)
    GNN: str = 'GCN'
    edge_mlp_type: str = 'GCN'
    nhid: int = 256
    drop_rate: float = 0.3
    gat_heads: int = 1            # reference GAT wrapper leaves PyG default heads=1
    # pipelines (parser.py:65-66, 98-107)
    sparse_edge_mlp: bool = False
    conditional: bool = True
    pipeline: str = 'two_pass'
    hybrid_checkpoint: bool = False
    # TPU-first hybrid variant: score the full edge set without grad (for
    # sampling only) and re-run the score head with grad on just the q
    # sampled edges. Gradient structure is identical to the reference
    # hybrid (grads reach the scorer only through probs_full[idx],
    # training_hybrid.py:86); only the head's dropout noise decouples
    # between the sampling pass and the weight pass. Cuts the backward
    # from E to q edges. False = exact reference dataflow.
    hybrid_rescore: bool = True
    # sampling (parser.py:76-79, 84)
    sample_perc: float = 0.20
    t_init: float = 0.7
    t_min: float = 0.5
    degree_bias_coef: float = 0.3
    # regularizers (parser.py:80-83)
    regularizer1_coef: float = 1.0
    reg1: bool = True
    reg2: bool = True
    consist_reg_coef: float = 0.5
    # run control (parser.py:67-75, 86, 91)
    eval: bool = True
    runs: int = 1
    seed: int = 42
    dataset: str = 'SmallCora'
    mode: str = 'learned'
    lr: float = 0.001
    weight_decay: float = 0.0005
    epochs: int = 200
    metis_threshold: int = 500000
    num_samples_eval: int = 11
    convergence: float = 0.0001
    # data (parser.py:92-97)
    ER: bool = False
    ERcompute: bool = False
    syn: bool = False
    degree: int = 100
    train: float = 0.2
    hn: float = 0.1
    # reporting (parser.py:88-90, 105-106)
    save_csv: bool = True
    plot_curve: bool = False
    log: bool = False
    gpu_profile: bool = False
    stats: bool = False
    # TPU-specific additions (no reference analogue)
    data_dir: str = './Dataset'
    results_dir: str = './Results'
    dtype: str = 'float32'        # compute dtype for backbones
    prng_impl: str = 'threefry2x32'  # 'rbg' = fast TPU PRNG for big runs
    approx_topk: bool = False     # approx_max_k sampling (~5x faster at 1M)
    # bf16 Gumbel keys for the approx top-k reduction (halves its HBM
    # traffic; ~8-bit mantissa creates ties among the top-q that perturb the
    # sampling distribution slightly — well inside the approx reduction's
    # own recall noise). Only engages with approx_topk on a TPU backend;
    # reported by log_fastpath_status. SGS_TOPK_BF16=off remains an
    # emergency env kill-switch.
    topk_bf16: bool = True
    checkpoint_every: int = 0     # save full train state every N epochs
    resume: bool = False          # resume from the latest checkpoint
    debug_checks: bool = False    # validate graph batches at prep time
    data_parallel: str = 'off'    # 'on' = shard partitions over the mesh
                                  # (synchronous grad-psum superset mode)
    halo: bool = False            # halo-exchange mode: FULL-GRAPH semantics
                                  # with partitioned storage (parallel/
                                  # halo_train.py); all four backbones
    # multi-host execution (jax.distributed over ICI x DCN); one process per
    # host, each loading its own partition group (parallel/distributed.py)
    multihost: bool = False
    coordinator_address: str = ''  # host:port of process 0
    num_processes: int = 1
    process_id: int = 0
    # dense-subgraph execution (ops/dense_graph.py): densify each per-step
    # sampled subgraph into an (N, N) adjacency and run message passing as
    # MXU matmuls. 'auto' = on-TPU for small-N partitions; 'on'/'off' force.
    dense_subgraph: str = 'auto'
    dense_threshold: int = 4096   # max node count for the dense route
    # fused tile-pair score kernel (ops/score_tiles.py): build the tile-pair
    # edge index at graph prep so the hybrid_rescore sampling pass runs the
    # Pallas kernel. 'auto' = on-TPU only (the kernel needs Mosaic; CPU runs
    # score via XLA); 'on' forces the tile layout on any backend (the
    # portable fallback computes the same tile-order scores).
    tile_index: str = 'auto'
    # whole-epoch device-side scan over stacked cluster batches: one
    # dispatch per epoch instead of one per batch (run/driver.py use_scan)
    scan_epoch: str = 'auto'
    # r5 sorted-head fast path: sort the q sampled indices on device so the
    # fused sampled-edge head (ops/score_sampled.py) runs its near-sorted
    # endpoint's one-hot select/scatter banded ((band, B) panels instead of
    # (N, B)); a per-step in-graph coverage check falls back to the full
    # kernel on pathological samples. 'auto' = sort whenever the hybrid
    # fast path runs; 'off' = keep sampler order (A/B escape hatch).
    sorted_head: str = 'auto'
    # padded edge-shape classes for partition batches (data/partition.py
    # shape_class_targets): 1 = every batch pads to the global max edge
    # count (one executable); k>1 groups partitions into up to k padded
    # shapes, each compiled separately — recovers the padded-slot waste of
    # skewed partitions (valid/padded 0.84 -> ~0.97 on the Reddit-scale
    # workload). Forced to 1 under data_parallel (shard_map stacks need one
    # uniform shape).
    shape_classes: int = 3
    num_partitions: int = 0       # 0 = auto from metis_threshold (main.py:41-54)
    mesh_shape: Optional[tuple] = None  # device mesh for partition parallelism
    donate: bool = True

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)

    def validate(self):
        """Check every field so typos die at config time, not deep in a
        trace. A dataset outside DATASETS is allowed iff a converted npz
        cache exists under data_dir (data/registry.py npz convention)."""
        import os

        def check(ok, msg):
            if not ok:
                raise ValueError(f"Config: {msg}")

        check(self.GNN in GNNS, f"GNN={self.GNN!r} not in {GNNS}")
        check(self.edge_mlp_type in EDGE_MLPS,
              f"edge_mlp_type={self.edge_mlp_type!r} not in {EDGE_MLPS}")
        check(self.pipeline in PIPELINES,
              f"pipeline={self.pipeline!r} not in {PIPELINES}")
        check(self.mode in MODES, f"mode={self.mode!r} not in {MODES}")
        npz = os.path.join(self.data_dir, f"{self.dataset}.npz")
        if self.dataset not in DATASETS and not os.path.exists(npz):
            # probe for an actual loadable vendored format, not a bare
            # directory: a dir with no marker file would fail much later
            # with a less actionable error (has_vendored below)
            check(has_vendored(self.data_dir, self.dataset),
                  f"dataset={self.dataset!r} not in DATASETS, no cache at "
                  f"{npz}, and no vendored marker file (x.pt, adj_full.npz, "
                  f"out1_graph_edges.txt, <name>.mat, class_map.json) under "
                  f"{os.path.join(self.data_dir, self.dataset)} (the "
                  f"notebook-only reference datasets — OGB_MAG, Reddit2, "
                  f"RedditSynthetic — load from vendored formats)")
        check(self.dtype in ("float32", "bfloat16"),
              f"dtype={self.dtype!r} must be float32|bfloat16")
        check(self.prng_impl in ("threefry2x32", "rbg"),
              f"prng_impl={self.prng_impl!r} must be threefry2x32|rbg")
        check(self.data_parallel in ("on", "off"),
              f"data_parallel={self.data_parallel!r} must be on|off")
        check(0.0 < self.sample_perc <= 1.0,
              f"sample_perc={self.sample_perc} not in (0, 1]")
        check(0.0 <= self.drop_rate < 1.0,
              f"drop_rate={self.drop_rate} not in [0, 1)")
        check(0.0 <= self.degree_bias_coef <= 1.0,
              f"degree_bias_coef={self.degree_bias_coef} not in [0, 1]")
        check(self.t_min <= self.t_init,
              f"t_min={self.t_min} > t_init={self.t_init}")
        check(0.0 < self.train < 1.0, f"train={self.train} not in (0, 1)")
        check(0.0 <= self.hn <= 1.0, f"hn={self.hn} not in [0, 1]")
        check(self.nhid > 0, f"nhid={self.nhid} must be > 0")
        check(self.gat_heads >= 1, f"gat_heads={self.gat_heads} must be >= 1")
        check(self.epochs > 0, f"epochs={self.epochs} must be > 0")
        check(self.runs > 0, f"runs={self.runs} must be > 0")
        check(self.lr > 0, f"lr={self.lr} must be > 0")
        check(self.weight_decay >= 0,
              f"weight_decay={self.weight_decay} must be >= 0")
        check(self.metis_threshold > 0,
              f"metis_threshold={self.metis_threshold} must be > 0")
        check(self.num_samples_eval >= 1,
              f"num_samples_eval={self.num_samples_eval} must be >= 1")
        check(self.convergence >= 0,
              f"convergence={self.convergence} must be >= 0")
        check(self.degree > 0, f"degree={self.degree} must be > 0")
        check(self.regularizer1_coef >= 0 and self.consist_reg_coef >= 0,
              "regularizer coefficients must be >= 0")
        check(self.checkpoint_every >= 0,
              f"checkpoint_every={self.checkpoint_every} must be >= 0")
        check(self.dense_subgraph in ("auto", "on", "off"),
              f"dense_subgraph={self.dense_subgraph!r} must be auto|on|off")
        check(self.sorted_head in ("auto", "off"),
              f"sorted_head={self.sorted_head!r} must be auto|off")
        check(self.tile_index in ("auto", "on", "off"),
              f"tile_index={self.tile_index!r} must be auto|on|off")
        check(self.scan_epoch in ("auto", "off"),
              f"scan_epoch={self.scan_epoch!r} must be auto|off")
        check(self.dense_threshold > 0,
              f"dense_threshold={self.dense_threshold} must be > 0")
        check(self.num_partitions >= 0,
              f"num_partitions={self.num_partitions} must be >= 0")
        check(1 <= self.shape_classes <= 16,
              f"shape_classes={self.shape_classes} not in [1, 16]")
        check(self.seed >= 0, f"seed={self.seed} must be >= 0")
        check(not self.multihost or self.num_processes >= 1,
              f"num_processes={self.num_processes} must be >= 1")
        check(0 <= self.process_id < max(self.num_processes, 1),
              f"process_id={self.process_id} not in [0, {self.num_processes})")


def has_vendored(data_dir: str, name: str) -> bool:
    """Does any vendored-format marker file exist for ``name``?  The same
    probe as the JAX package's loader resolution, without loading."""
    import os
    lname = name.lower()
    candidates = (
        os.path.join(data_dir, f"{name}.mat"),
        os.path.join(data_dir, name, "raw", f"{lname}.mat"),
        os.path.join(data_dir, name, "out1_graph_edges.txt"),
        os.path.join(data_dir, name, "raw", "out1_graph_edges.txt"),
        os.path.join(data_dir, "LINKXdataset", name, "x.pt"),
        os.path.join(data_dir, name, "x.pt"),
        os.path.join(data_dir, name, "raw", "adj_full.npz"),
        os.path.join(data_dir, name, "adj_full.npz"),
        os.path.join(data_dir, name, "class_map.json"),
    )
    return any(os.path.exists(c) for c in candidates)

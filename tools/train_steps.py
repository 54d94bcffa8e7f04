#!/usr/bin/env python3
"""Time the hybrid_rescore and two_pass training steps of the checkout at
ROOT (its own chip_smoke.py and sgs_gnn_tpu_torch) on one NVIDIA card: a
``train`` and a ``profile`` line each, as chip_smoke.py prints them.

    python3 tools/train_steps.py ROOT

For a parent/change comparison on one card, unpack both commits with
``git archive`` into a git-ignored directory and run them in turns
(parent, change, change, parent):

    for d in tmp/parent tmp/change tmp/change tmp/parent; do
        python3 tools/train_steps.py $d; done
"""
import sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from sgs_gnn_tpu_torch import Graph
from sgs_gnn_tpu_torch.data import degree_prior
from sgs_gnn_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
x, ei, y, tr = cs.build_partition()
g = Graph.build(x, ei, y, tr, ~tr, None, device="cuda",
                prob=degree_prior(ei[0], ei[1], cs.N_NODES),
                num_classes=cs.CLASSES, sort_by_receiver=True, tile_index=True)
for name in ("hybrid_rescore", "two_pass"):
    overrides, steps, expect = cs.PIPELINES[name]
    if hasattr(cs, "pipeline_launches"):   # checkouts that route two_pass's
        expect = cs.pipeline_launches(name)  # first pass to K8
    cfg = dict(mode="learned", conditional=True, sparse_edge_mlp=True,
               reg1=True, reg2=True, nhid=cs.NHID, dtype="bfloat16",
               **overrides)
    cs._train_path(torch, g, name, cfg, steps, expect)

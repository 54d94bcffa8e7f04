"""MLP scorer's encoder: one per-node projection to nhid, relu, dropout;
no propagation, so ``s`` and ``r`` are not read.

Departures from the published encoder (the reference's per-node
``fcdim`` projection before the shared head): none in the arithmetic; the
projection rounds at the configuration's precision."""
import torch

from benchmark import counts
from benchmark import reference as R


def encode(m, x, s, r, n, gen):
    h = torch.relu(R.linear(x, m.P["edge_prob_mlp.fcdim.weight"],
                            m.P["edge_prob_mlp.fcdim.bias"], m.pr))
    if gen is not None:
        h = R.dropout(h, m.rate, gen)
    return h


def count(cfg, n, e):
    return counts.dense(n, cfg["num_features"], cfg["nhid"], False)

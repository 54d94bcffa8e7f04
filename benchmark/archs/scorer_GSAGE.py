"""GraphSAGE scorer's encoder: one mean-aggregating SAGE layer of width
nhid on the raw features, relu, dropout."""
import torch

from benchmark import counts
from benchmark import reference as R


def encode(m, x, s, r, n, gen):
    h = torch.relu(R.sage(m.P, "edge_prob_mlp.gcn1", x, s, r, n, m.pr))
    if gen is not None:
        h = R.dropout(h, m.rate, gen)
    return h


def count(cfg, n, e):
    return counts.sage_layer(n, e, cfg["num_features"], cfg["nhid"])

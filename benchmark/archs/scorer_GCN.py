"""GCN scorer's encoder: two unweighted GCN layers of width nhid, relu
after each, dropout between them."""
import torch

from benchmark import counts
from benchmark import reference as R


def encode(m, x, s, r, n, gen):
    h = torch.relu(R.gcn(m.P, "edge_prob_mlp.gcn1", x, s, r, None, n,
                         m.pr))
    if gen is not None:
        h = R.dropout(h, m.rate, gen)
    return torch.relu(R.gcn(m.P, "edge_prob_mlp.gcn2", h, s, r, None, n,
                            m.pr))


def count(cfg, n, e):
    fin, k = cfg["num_features"], cfg["nhid"]
    a = counts.gcn_layer(n, e, fin, k, False)
    b = counts.gcn_layer(n, e, k, k, True)
    return a[0] + b[0], a[1] + b[1]

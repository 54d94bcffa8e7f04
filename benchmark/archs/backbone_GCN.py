"""GCN backbone: a GCN layer to nhid, relu, dropout, a GCN layer to the
classes; the scorer's edge weights weight both layers' sums."""
import torch

from benchmark import counts
from benchmark import reference as R


def forward(m, x, s, r, w, n, gen):
    h = torch.relu(R.gcn(m.P, "gcn1", x, s, r, w, n, m.pr))
    if gen is not None:
        h = R.dropout(h, m.rate, gen)
    return R.gcn(m.P, "gcn2", h, s, r, w, n, m.pr)


def count(cfg, n, e):
    fin, k, c = cfg["num_features"], cfg["nhid"], cfg["num_classes"]
    a = counts.gcn_layer(n, e, fin, k, False)
    b = counts.gcn_layer(n, e, k, c, True)
    return a[0] + b[0], a[1] + b[1]

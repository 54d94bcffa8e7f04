"""GAT backbone: a GATv1 layer of ``gat_heads`` heads of width nhid,
concatenated, relu, dropout, a one-head GATv1 layer to the classes. The
attention takes no edge weight: ``w`` is not read."""
import torch

from benchmark import counts
from benchmark import reference as R


def forward(m, x, s, r, w, n, gen):
    h = torch.relu(R.gat(m.P, "GAT_conv1", x, s, r, n, True, m.pr))
    if gen is not None:
        h = R.dropout(h, m.rate, gen)
    return R.gat(m.P, "GAT_conv2", h, s, r, n, False, m.pr)


def count(cfg, n, e):
    fin, c = cfg["num_features"], cfg["num_classes"]
    hk = cfg["nhid"] * cfg["gat_heads"]
    a = counts.gat_layer(n, e, fin, hk, False)
    b = counts.gat_layer(n, e, hk, c, True)
    return a[0] + b[0], a[1] + b[1]

"""The benchmark's inputs, made from ``--seed`` on the host.

Frozen copies, so that a change to the program cannot change what the
benchmark feeds it:

  * ``community_sbm_graph``: the generator of SyntheticReddit (the port's
    ``data/synthetic.py``), the same draws, the edges' from a generator
    of their own;
  * ``to_undirected``: PyG's symmetrisation with duplicates removed;
  * ``degree_prior``: the reference's inverse-degree edge prior
    (``data/priors.py``).

``make_inputs`` runs them at a configuration's sizes. The graph's
structure (the edges, hence the partitions and every shape the program
sees) comes from the fixed ``STRUCTURE_SEED``; the seed draws the labels,
the features and the masks, and the program's weights and every random
draw of its run. So every seed gives the program the same work, its
content changed: runs with two seeds differ as two runs of one seed do.
The seed may be any whole number up to a little over 2**31; it is folded
into numpy's seed sequence whole.
"""
from __future__ import annotations

import numpy as np


STRUCTURE_SEED = 0


def community_sbm_graph(n, num_classes, communities, deg, h, p_local,
                        feat_dim, feat_noise, train, seed,
                        structure_seed=STRUCTURE_SEED):
    """Reddit-shaped graph: n nodes, n * deg directed draws, pareto-skewed
    senders, ``p_local`` of edges inside one of ``communities`` contiguous
    blocks (drawn from ``structure_seed``), community-correlated labels,
    Gaussian class-centred features and random train / val / test masks
    (drawn from ``seed``)."""
    rng = np.random.default_rng(seed)
    comm = (np.arange(n, dtype=np.int64) * communities // n).astype(np.int32)
    majority = (comm % num_classes).astype(np.int32)
    y = np.where(rng.random(n) < h, majority,
                 rng.integers(0, num_classes, n)).astype(np.int32)
    cstart = (np.arange(communities, dtype=np.int64) * n) // communities
    csize = np.diff(np.concatenate([cstart, [n]]))
    e = n * deg
    srng = np.random.default_rng(structure_seed)
    w = srng.pareto(1.5, n) + 1.0
    senders = srng.choice(n, e, p=w / w.sum()).astype(np.int32)
    local = srng.random(e) < p_local
    tcomm = np.where(local, comm[senders],
                     srng.integers(0, communities, e)).astype(np.int64)
    receivers = (cstart[tcomm]
                 + (srng.random(e) * csize[tcomm]).astype(np.int64)
                 ).astype(np.int32)
    keep = senders != receivers
    ei = np.stack([senders[keep], receivers[keep]])
    centers = rng.normal(size=(num_classes, feat_dim))
    x = (centers[y] + feat_noise * rng.normal(size=(n, feat_dim))
         ).astype(np.float32)
    perm = rng.permutation(n)
    val = (1 - train) / 2
    n_tr, n_va = int(train * n), int(val * n)
    masks = [np.zeros(n, bool) for _ in range(3)]
    masks[0][perm[:n_tr]] = True
    masks[1][perm[n_tr:n_tr + n_va]] = True
    masks[2][perm[n_tr + n_va:]] = True
    return x, ei, y, masks


def to_undirected(edge_index):
    """Both directions of every edge, duplicates removed, sorted by
    sender * n + receiver."""
    s = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    r = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    n = int(max(s.max(), r.max())) + 1
    key = s * n + r
    del s, r
    key.sort()
    keep = np.empty(key.shape, bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    key = key[keep]
    return np.stack([key // n, key % n]).astype(np.int32)


def degree_prior(senders, receivers, num_nodes):
    """prob_e = 1 / (in-count[sender] + out-count[receiver]), then
    softmax(prob * E**-0.5), in float64, returned as float32."""
    e = len(senders)
    if e == 0:
        return np.zeros(0, np.float32)
    col = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    row = np.bincount(senders, minlength=num_nodes).astype(np.float64)
    prob = 1.0 / (col[senders] + row[receivers] + 1e-10)
    v = prob * e ** -0.5
    v = np.exp(v - v.max())
    return (v / v.sum()).astype(np.float32)


def fold_seed(seed):
    """numpy's seed sequence takes any whole number >= 0; a negative one is
    folded into [0, 2**64)."""
    return int(seed) % (1 << 64)


def make_inputs(graph_cfg, seed):
    """(x, edge_index, y, (train, val, test), prior) of a configuration's
    ``graph`` block, from ``seed``."""
    g = graph_cfg
    x, ei, y, masks = community_sbm_graph(
        g["num_nodes"], g["num_classes"], g["communities"], g["deg"], g["h"],
        g["p_local"], g["num_features"], g["feat_noise"], g["train"],
        fold_seed(seed))
    ei = to_undirected(ei)
    prior = degree_prior(ei[0], ei[1], x.shape[0])
    return x, ei, y, masks, prior

"""Synthetic graph generators (own numpy copy of the JAX package's
``data/synthetic.py``: the same draws in the same order from the same
``np.random.default_rng``, so a seed gives the same graph in both packages).

Host-side numpy ports of the reference's de-facto test fixtures:
  * generate_synthetic — rewire a labeled node set to target degree d and
    homophily h (reference Dataset.ipynb cell 31)
  * moon_graph — two-moons point cloud with degree/homophily-controlled
    random graph (reference Moon.ipynb cells 5-7)
  * karate_club — Zachary's karate club (reference datasets.py:46-47 via
    PyG KarateClub; data is public domain, re-entered from the original
    1977 study's edge list)
  * sbm_graph — stochastic-block-model fixture, new in this framework,
    used as the always-available stand-in for downloadable datasets
"""
from __future__ import annotations


import numpy as np


def rewire_to_homophily(y: np.ndarray, d: int, h: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Reference generate_synthetic's edge construction: every node draws
    round(d*h) intra-class and round(d*(1-h)) inter-class neighbors without
    replacement."""
    n = len(y)
    num_class = int(y.max()) + 1
    intra_d = int(np.round(d * h))
    inter_d = int(np.round(d * (1 - h)))
    cls_nodes = [np.where(y == c)[0] for c in range(num_class)]
    src, dst = [], []
    for c in range(num_class):
        intra = cls_nodes[c]
        inter = np.concatenate([cls_nodes[k] for k in range(num_class)
                                if k != c]) if num_class > 1 else np.array([], int)
        for u in intra:
            iv = rng.choice(intra, min(len(intra), intra_d), replace=False)
            ev = rng.choice(inter, min(len(inter), inter_d), replace=False) \
                if len(inter) else np.array([], int)
            vs = np.concatenate([iv, ev])
            src.extend([u] * len(vs))
            dst.extend(vs.tolist())
    return np.stack([np.array(src, np.int32), np.array(dst, np.int32)])


def sbm_graph(n: int = 800, num_classes: int = 4, deg: int = 12,
              h: float = 0.7, feat_dim: int = 64, feat_noise: float = 0.7,
              train: float = 0.2, seed: int = 0):
    """Stochastic-block-model-style labeled graph with gaussian class
    features. Returns (x, edge_index, y, train/val/test masks)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    ei = rewire_to_homophily(y, deg, h, rng)
    centers = rng.normal(size=(num_classes, feat_dim))
    x = (centers[y] + feat_noise * rng.normal(size=(n, feat_dim))
         ).astype(np.float32)
    masks = random_masks(n, train, (1 - train) / 2, rng)
    return x, ei, y, masks


def community_sbm_graph(n: int = 232_965, num_classes: int = 41,
                        communities: int = 128, deg: int = 330,
                        h: float = 0.95, p_local: float = 0.85,
                        feat_dim: int = 602, feat_noise: float = 1.0,
                        train: float = 0.66, seed: int = 0):
    """Reddit-shaped synthetic graph: ~n nodes, ~n*deg directed edges
    (before symmetrization), power-law-ish degrees, COMMUNITY structure
    (p_local of edges stay inside one of `communities` contiguous blocks —
    so a graph partitioner can retain most edges inside parts, like METIS
    does on the real Reddit: reference logs/memory_Reddit_hybrid.log:3-4),
    and edge homophily ~h. Fully vectorized (one bulk draw for all ~77M
    raw edges), so generation takes seconds, not the minutes the per-node
    rewire_to_homophily loop would need.

    Labels are COMMUNITY-CORRELATED (each community has a majority class,
    like subreddit topics): node i in community c gets class c % num_classes
    with probability ``h``, else uniform random. Receivers are drawn
    uniformly within the (contiguous) target community, so homophily
    emerges from community structure (He ~= p_local * h^2 + cross terms)
    instead of from tiny per-(community, class) pools — class-targeted
    draws would collapse under dedup (a node's ~150 same-class-local draws
    land in a ~44-node pool).

    Defaults mirror Reddit's shape: 232,965 nodes / ~114.6M directed edges
    after symmetrization / 602 features / 41 classes (reference
    main.py:41-67 partition decision input)."""
    rng = np.random.default_rng(seed)
    comm = (np.arange(n, dtype=np.int64) * communities // n).astype(np.int32)
    majority = (comm % num_classes).astype(np.int32)
    y = np.where(rng.random(n) < h, majority,
                 rng.integers(0, num_classes, n)).astype(np.int32)
    # contiguous community boundaries: comm c spans [c*n//C, (c+1)*n//C)
    cstart = (np.arange(communities, dtype=np.int64) * n) // communities
    csize = np.diff(np.concatenate([cstart, [n]]))

    # each node draws `deg` out-edges; symmetrization then roughly doubles
    # the directed count minus duplicate collisions (hot pareto senders
    # re-draw the same neighbors inside their ~1.8k-node community). The
    # default deg=330/h=0.95 measured avg directed degree 494 and
    # He=0.739 at matched community size — Reddit's 492 and 0.756
    e = n * deg
    w = rng.pareto(1.5, n) + 1.0
    senders = rng.choice(n, e, p=w / w.sum()).astype(np.int32)
    local = rng.random(e) < p_local
    tcomm = np.where(local, comm[senders],
                     rng.integers(0, communities, e)).astype(np.int64)
    receivers = (cstart[tcomm]
                 + (rng.random(e) * csize[tcomm]).astype(np.int64)
                 ).astype(np.int32)
    keep = senders != receivers
    ei = np.stack([senders[keep], receivers[keep]])

    centers = rng.normal(size=(num_classes, feat_dim))
    x = (centers[y] + feat_noise * rng.normal(size=(n, feat_dim))
         ).astype(np.float32)
    masks = random_masks(n, train, (1 - train) / 2, rng)
    return x, ei, y, masks


def random_masks(n: int, train: float, val: float,
                 rng: np.random.Generator):
    perm = rng.permutation(n)
    n_tr, n_va = int(train * n), int(val * n)
    tr = np.zeros(n, bool); tr[perm[:n_tr]] = True
    va = np.zeros(n, bool); va[perm[n_tr:n_tr + n_va]] = True
    te = np.zeros(n, bool); te[perm[n_tr + n_va:]] = True
    return tr, va, te


def moon_graph(n_samples: int = 1000, degree: int = 4, h: float = 0.2,
               train: float = 0.2, seed: int = 0):
    """Two-moons fixture (reference Moon.ipynb generate_moon/getMoonDataset):
    draw `degree` candidate neighbors per node, keep round(degree*h) same-
    class and the rest different-class, then symmetrize."""
    from sklearn.datasets import make_moons
    rng = np.random.default_rng(seed)
    x, y = make_moons(n_samples=n_samples, noise=0.05, random_state=seed,
                      shuffle=False)
    x = (x - x.min(0)).astype(np.float32)
    y = y.astype(np.int32)
    src, dst = [], []
    seen = set()
    same_n = int(np.round(degree * h))
    diff_n = degree - same_n
    for u in range(n_samples):
        cand = rng.choice(n_samples, degree, replace=False)
        same = [v for v in cand if y[v] == y[u]][:same_n]
        diff = [v for v in cand if y[v] != y[u]][:diff_n]
        for v in same + diff:
            if u != v and (u, v) not in seen:
                seen.add((u, v))
                src.append(u); dst.append(v)
    # symmetrize (getMoonDataset appends the reverse direction)
    ei = np.stack([np.array(src + dst, np.int32),
                   np.array(dst + src, np.int32)])
    masks = random_masks(n_samples, train, 0.3, rng)
    return x, ei, y, masks


# Zachary's karate club (1977), 34 nodes / 78 undirected edges; labels are
# the standard 4-community split used by PyG's KarateClub dataset.
_KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]
_KARATE_Y = [1, 1, 1, 1, 3, 3, 3, 1, 0, 1, 3, 1, 1, 1, 0, 0, 3, 1, 0, 1, 0,
             1, 0, 0, 2, 2, 0, 0, 2, 0, 0, 2, 0, 0]


def karate_club():
    """34-node Zachary fixture; one train node per community (PyG
    KarateClub semantics)."""
    n = 34
    e = np.array(_KARATE_EDGES, np.int32).T
    ei = np.concatenate([e, e[::-1]], axis=1)
    y = np.array(_KARATE_Y, np.int32)
    x = np.eye(n, dtype=np.float32)
    train = np.zeros(n, bool)
    for c in range(4):
        train[int(np.where(y == c)[0][0])] = True
    val = np.zeros(n, bool)
    test = ~train
    return x, ei, y, (train, val, test)


def reddit_style_subsample(senders, receivers, y, keep: float, h: float,
                           seed: int = 0):
    """Per-node edge subsampling keeping a target fraction homophilic
    (reference RedditSynthetic, Dataset.ipynb cell 11): keep `keep` of each
    node's out-edges, preferring same-label endpoints with probability h."""
    rng = np.random.default_rng(seed)
    same = y[senders] == y[receivers]
    score = rng.random(len(senders)) + np.where(same, h, 1.0 - h)
    order = np.argsort(-score)
    n_keep = int(len(senders) * keep)
    sel = np.sort(order[:n_keep])
    return senders[sel], receivers[sel]


def community_sbm_low_graph(n: int = 232_965, num_classes: int = 5,
                            communities: int = 128, deg: int = 330,
                            p_local: float = 0.85, edge_h: float = 0.2,
                            feat_dim: int = 602, feat_noise: float = 8.0,
                            train: float = 0.66, seed: int = 0):
    """The SyntheticSBMLow recipe at Reddit scale, with partitionable
    locality: labels are UNIFORM (clean class identity, unlike
    community_sbm_graph's noisy community-majority labels), community
    structure keeps p_local of edges inside contiguous communities (so the
    partitioner retains most edges, like METIS on the real Reddit), and
    every edge's target class is the sender's class with prob ``edge_h``
    (else a random other class). With edge_h ~= 1/num_classes the edge set
    is uninformative in aggregate — full-graph propagation destroys the
    (noisy) feature signal — while the same-class minority is there for a
    supervised sparsifier to find: the regime the method exists for
    (reference README.md:3-5; the 2k-node fixture is sbm_graph(h=0.2)).

    Fully vectorized via contiguous (community, class) target pools: one
    bulk draw for all ~77M raw edges, seconds not minutes."""
    rng = np.random.default_rng(seed)
    comm = (np.arange(n, dtype=np.int64) * communities // n).astype(np.int32)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    # contiguous (community, class) pools: order groups node ids
    key = comm.astype(np.int64) * num_classes + y
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=communities * num_classes)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    e = n * deg
    w = rng.pareto(1.5, n) + 1.0
    senders = rng.choice(n, e, p=w / w.sum()).astype(np.int32)
    local = rng.random(e) < p_local
    same = rng.random(e) < edge_h
    tcls = np.where(same, y[senders],
                    (y[senders] + rng.integers(1, num_classes, e))
                    % num_classes).astype(np.int64)
    tcomm = np.where(local, comm[senders],
                     rng.integers(0, communities, e)).astype(np.int64)
    pool = tcomm * num_classes + tcls
    psize = counts[pool]
    u = (rng.random(e) * np.maximum(psize, 1)).astype(np.int64)
    receivers = order[starts[pool]
                      + np.minimum(u, np.maximum(psize - 1, 0))]
    ok = (psize > 0) & (senders != receivers)
    ei = np.stack([senders[ok].astype(np.int32),
                   receivers[ok].astype(np.int32)])

    centers = rng.normal(size=(num_classes, feat_dim))
    x = (centers[y] + feat_noise * rng.normal(size=(n, feat_dim))
         ).astype(np.float32)
    masks = random_masks(n, train, (1 - train) / 2, rng)
    return x, ei, y, masks

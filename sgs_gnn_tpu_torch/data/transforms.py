"""Host-side graph transforms used by dataset preparation (own numpy copy
of the JAX package's ``data/transforms.py``, same functions and results).

Numpy ports of the PyG utilities the reference composes in get_dataset
(reference datasets.py:176-232): to_undirected, adjacency-SVD feature
augmentation, deterministic train/val/test splits, edge homophily.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def to_undirected(edge_index: np.ndarray) -> np.ndarray:
    """Symmetrize + coalesce duplicate edges (PyG to_undirected; reference
    datasets.py:189-190): the distinct (s, r) pairs of both directions,
    sorted by s * n + r. The pairs are decoded from the sorted distinct
    keys, which equals gathering each key's first occurrence (the JAX
    package's ``np.unique(..., return_index=True)``) without its stable
    argsort."""
    s = np.concatenate([edge_index[0], edge_index[1]])
    r = np.concatenate([edge_index[1], edge_index[0]])
    if not len(s):
        return np.zeros((2, 0), np.int32)
    n = max(int(s.max()), int(r.max())) + 1
    key = s.astype(np.int64) * n + r
    # sorted in place, not copied as np.unique would: the keys of a
    # Reddit-sized graph take 1.9 GB
    del s, r
    key.sort()
    keep = np.empty(key.shape, bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    key = key[keep]
    return np.stack([key // n, key % n]).astype(np.int32)


def is_undirected(edge_index: np.ndarray, num_nodes: int) -> bool:
    a = sp.coo_matrix((np.ones(edge_index.shape[1]),
                       (edge_index[0], edge_index[1])),
                      shape=(num_nodes, num_nodes)).tocsr()
    a.data[:] = 1
    return (a != a.T).nnz == 0


def adj_svd_features(edge_index: np.ndarray, num_nodes: int,
                     in_dim: int, max_components: int = 256) -> np.ndarray:
    """Truncated-SVD embedding of the (symmetrized) adjacency, concatenated
    to node features for Squirrel/Chameleon/Amazon-ratings/reed98
    (reference adj_feature, datasets.py:20-36). Sparse SVD instead of the
    reference's dense N x N materialization."""
    from sklearn.decomposition import TruncatedSVD
    n_comp = min(max_components, in_dim, num_nodes - 1)
    a = sp.coo_matrix((np.ones(edge_index.shape[1]),
                       (edge_index[0], edge_index[1])),
                      shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float32).tocsr()
    svd = TruncatedSVD(n_components=n_comp, random_state=0)
    return svd.fit_transform(a).astype(np.float32)


def train_val_test_masks(num_nodes: int, train: float = 0.2, val: float = 0.4,
                         test: float = 0.4, random_state: int = 1):
    """Deterministic split via sklearn train_test_split with random_state=1
    (reference train_val_test_mask, datasets.py:109-139)."""
    from sklearn.model_selection import train_test_split
    idx = list(range(num_nodes))
    tr_idx, rest = train_test_split(idx, test_size=val + test,
                                    random_state=random_state)
    va_idx, te_idx = train_test_split(rest, test_size=test / (val + test),
                                      random_state=random_state)
    tr = np.zeros(num_nodes, bool); tr[tr_idx] = True
    va = np.zeros(num_nodes, bool); va[va_idx] = True
    te = np.zeros(num_nodes, bool); te[te_idx] = True
    return tr, va, te


def edge_homophily(edge_index: np.ndarray, y: np.ndarray) -> float:
    """Fraction of edges with same-label endpoints (PyG homophily
    method='edge'; reference datasets.py:222)."""
    if edge_index.shape[1] == 0:
        return 0.0
    return float(np.mean(y[edge_index[0]] == y[edge_index[1]]))


def node_homophily(edge_index: np.ndarray, y: np.ndarray,
                   num_nodes: int) -> float:
    """Mean per-node fraction of same-label neighbors (PyG homophily
    method='node'; logged by the reference synthetic generator,
    Dataset.ipynb cell 31)."""
    s, r = edge_index
    same = (y[s] == y[r]).astype(np.float64)
    deg = np.bincount(r, minlength=num_nodes).astype(np.float64)
    same_cnt = np.bincount(r, weights=same, minlength=num_nodes)
    has = deg > 0
    if not has.any():
        return 0.0
    return float((same_cnt[has] / deg[has]).mean())


def assortativity(edge_index: np.ndarray, num_nodes: int) -> float:
    """Degree assortativity (Pearson correlation of endpoint degrees over
    edges) — the reference logs this for synthetic graphs."""
    s, r = edge_index
    deg = np.bincount(np.concatenate([s, r]), minlength=num_nodes)
    ds_, dr_ = deg[s].astype(np.float64), deg[r].astype(np.float64)
    if ds_.std() == 0 or dr_.std() == 0:
        return 0.0
    return float(np.corrcoef(ds_, dr_)[0, 1])

"""Sampling priors: degree prior and effective-resistance prior (own numpy
copy of the JAX package's ``data/priors.py``, same estimators, same draws
and the same ``<name>_erweight.npy`` cache file).

Host-side (numpy) one-time preprocessing, mirroring reference
datasets.py:141-173 and EffectiveResistanceWeights.ipynb. The reference's
random-walk ER estimator does serial Python walks per edge under a
multiprocessing pool; here the walks are vectorized over all nodes at once
(CSR neighbor sampling), which is the same estimator orders of magnitude
faster — no per-edge Python loop.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp


def _softmax(v):
    v = v - v.max()
    e = np.exp(v)
    return e / e.sum()


def degree_prior(senders, receivers, num_nodes: int) -> np.ndarray:
    """Inverse-degree edge prior (reference add_degree, datasets.py:141-156):
    prob_e = 1 / (indeg[sender_e] + outdeg[receiver_e]), then
    softmax(prob * E^{-1/2}) for low variance."""
    indeg = np.bincount(senders, minlength=num_nodes).astype(np.float64)
    # colcount()[row]: in-degree counts entries per column; the reference's
    # SparseTensor(row=ei[0], col=ei[1]) makes colcount the receiver count
    # indexed at the sender, rowcount the sender count indexed at receiver.
    col_count = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    row_count = np.bincount(senders, minlength=num_nodes).astype(np.float64)
    prob = col_count[senders] + row_count[receivers]
    prob = 1.0 / (prob + 1e-10)
    e = len(senders)
    if e == 0:
        # an empty partition (kept under data_parallel; the JAX function
        # raises ZeroDivisionError here)
        return np.zeros(0, np.float32)
    return _softmax(prob * e ** -0.5).astype(np.float32)


def effective_resistance_exact(senders, receivers, num_nodes: int
                               ) -> np.ndarray:
    """Exact per-edge effective resistance via pseudo-inverse Laplacian
    (reference `EffectiveResistance`, EffectiveResistanceWeights.ipynb
    cell 9). O(N^3) — small graphs only."""
    a = sp.coo_matrix((np.ones(len(senders)), (senders, receivers)),
                      shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float64)
    lap = sp.csgraph.laplacian(a, normed=False)
    l_inv = np.linalg.pinv(lap.toarray())
    diag = np.diag(l_inv)
    r = diag[senders] + diag[receivers] - l_inv[senders, receivers] \
        - l_inv[receivers, senders]
    return np.maximum(r, 0.0).astype(np.float32)


def _csr_undirected(senders, receivers, num_nodes):
    a = sp.coo_matrix((np.ones(len(senders)), (senders, receivers)),
                      shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.int8).tocsr()
    return a


def effective_resistance_rw(senders, receivers, num_nodes: int,
                            walk_lengths: int = 4, walks: int = 100,
                            seed: int = 0) -> np.ndarray:
    """Random-walk ER delta estimator (reference `EffectiveRessistance.
    er_edge`, EffectiveResistanceWeights.ipynb cell 11: l=4 lengths x r=100
    walks per endpoint):

        R(s,t) ~= sum_{i<l} (X_i^s(s)/d_s - X_i^s(t)/d_t
                             - X_i^t(s)/d_s + X_i^t(t)/d_t) / r

    where X_i^u(v) counts walks of length i from u ending at v. Vectorized:
    run r walks of each length from EVERY node once, then answer all edges
    with gather-compares — identical estimator, no per-edge loop.
    """
    rng = np.random.default_rng(seed)
    a = _csr_undirected(senders, receivers, num_nodes)
    indptr, indices = a.indptr, a.indices
    deg = np.diff(indptr)
    safe_deg = np.maximum(deg, 1)

    # endpoints[i] has shape (walks, N): where walks of length i land
    endpoints = np.empty((walk_lengths, walks, num_nodes), dtype=np.int64)
    cur = np.broadcast_to(np.arange(num_nodes), (walks, num_nodes)).copy()
    endpoints[0] = cur  # length-0 walks stay at the start node
    for i in range(1, walk_lengths):
        # one random neighbor hop for every active walk; isolated nodes stay
        offs = rng.integers(0, safe_deg[cur])
        nxt = indices[indptr[cur] + offs]
        cur = np.where(deg[cur] > 0, nxt, cur)
        endpoints[i] = cur

    d = safe_deg.astype(np.float64)
    e = len(senders)
    delta = np.zeros(e, dtype=np.float64)
    s, t = senders, receivers
    for i in range(walk_lengths):
        ends = endpoints[i]  # (walks, N)
        xis = (ends[:, s] == s[None, :]).sum(0)   # walks from s landing on s
        xit = (ends[:, s] == t[None, :]).sum(0)   # walks from s landing on t
        yis = (ends[:, t] == s[None, :]).sum(0)
        yit = (ends[:, t] == t[None, :]).sum(0)
        delta += (xis / d[s] - xit / d[t] - yis / d[s] + yit / d[t]) / walks
    return np.maximum(delta, 0.0).astype(np.float32)


def er_prior(senders, receivers, num_nodes: int, cache_dir: str = "",
             dataset_name: str = "", recompute: bool = False,
             exact_threshold: int = 2000) -> np.ndarray:
    """ER-based sampling prior with on-disk caching
    (reference add_ER, datasets.py:159-173): softmax(w * E^{-1/2})."""
    cache = os.path.join(cache_dir, f"{dataset_name}_erweight.npy") \
        if cache_dir and dataset_name else None
    if cache and os.path.exists(cache) and not recompute:
        w = np.load(cache)
    else:
        if num_nodes <= exact_threshold:
            w = effective_resistance_exact(senders, receivers, num_nodes)
        else:
            w = effective_resistance_rw(senders, receivers, num_nodes)
        if cache:
            os.makedirs(cache_dir, exist_ok=True)
            np.save(cache, w)
    e = len(w)
    return _softmax(w.astype(np.float64) * e ** -0.5).astype(np.float32)

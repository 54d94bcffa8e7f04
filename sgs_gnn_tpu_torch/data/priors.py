"""Degree prior (own numpy copy of the JAX package's ``data/priors.py``
``degree_prior``; host-side, one-time preprocessing)."""
from __future__ import annotations

import numpy as np


def _softmax(v):
    v = v - v.max()
    e = np.exp(v)
    return e / e.sum()


def degree_prior(senders, receivers, num_nodes: int) -> np.ndarray:
    """Inverse-degree edge prior (reference add_degree): prob_e =
    1 / (indeg[sender_e] + outdeg[receiver_e]), then softmax(prob * E^-1/2).

    The reference's SparseTensor(row=senders, col=receivers) makes colcount
    the receiver count indexed at the sender and rowcount the sender count
    indexed at the receiver."""
    col_count = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    row_count = np.bincount(senders, minlength=num_nodes).astype(np.float64)
    prob = col_count[senders] + row_count[receivers]
    prob = 1.0 / (prob + 1e-10)
    e = len(senders)
    return _softmax(prob * e ** -0.5).astype(np.float32)

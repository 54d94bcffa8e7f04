"""Dense-subgraph message passing (port of ``ops/dense_graph.py``): a
per-step sampled subgraph densified into an (N, N) adjacency, so that every
aggregation over it becomes an (N, N) @ (N, F) matrix product.

Cluster partitions are edge-heavy and node-light (~1M directed edges over
~2k nodes): N^2 is a few million entries. The JAX package densifies the
scorer's propagation graph and the conditional gate's random subgraph
(``train/pipelines.py``) on a TPU, where a dense product is cheap and a
per-edge gather is not. Here ``DenseEdges`` takes the place of the
``senders`` argument of the layers (``receivers`` then None), which
dispatch on its type (``models/layers.py``).

Row convention: ``adj[r, s]`` = total weight of the edges s -> r, so
``adj @ x`` is ``spmm(senders, receivers, w, x, n)``.

No TPU kernel is involved: in JAX the build is an XLA scatter and the
product a plain matrix product, so here they are ``index_add_`` and
``torch.matmul``.
"""
from __future__ import annotations

import dataclasses

import torch

# the device types on which ``dense_subgraph='auto'`` densifies. JAX's auto
# engages on a TPU only (its XLA:CPU product loses to the scatter); whether
# it should on the card is for the card's measurements to decide
# (PERF.md, chip_smoke.py's dense phase), so none yet
AUTO_DEVICE_TYPES = ()


@dataclasses.dataclass(frozen=True)
class DenseEdges:
    """A densified subgraph: ``adj[r, s]`` = total edge weight s -> r,
    float32, no self-loops added (the layers add their own, as on the COO
    route)."""
    adj: torch.Tensor  # (N, N) float32

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]


def dense_adj(senders, receivers, n: int, weights=None,
              valid=None) -> DenseEdges:
    """Scatter an edge list into a dense (N, N) adjacency over the flat ids
    ``r * n + s``. Duplicate edges accumulate (the sparse sums' semantics);
    ``valid`` (bool per edge) zeroes padding selections; ``weights`` may
    carry gradients (the VJP of the scatter is a gather of the cotangent
    at the same flat ids).

    Unweighted, every entry is an integer multiplicity (a sum of ones or
    of 0/1 validities), which f32 holds exactly below 2**24: the matrix
    does not depend on the order in which the card's atomics add."""
    flat = receivers.long() * n + senders.long()
    w = (torch.ones(senders.shape[0], dtype=torch.float32,
                    device=senders.device)
         if weights is None else weights.float())
    if valid is not None:
        w = torch.where(valid, w, 0.0)
    a = torch.zeros(n * n, dtype=torch.float32, device=senders.device)
    return DenseEdges(a.index_add(0, flat, w).reshape(n, n))


def dense_supported(gnn: str, edge_mlp_type: str) -> bool:
    """Backbone / scorer pairs with a dense layer route: every one (GAT
    runs a multiplicity-weighted masked dense row softmax)."""
    return gnn in ("GCN", "GIN", "Cheb", "GAT") and \
        edge_mlp_type in ("GCN", "MLP", "GSAGE")


def use_dense_subgraph(cfg, n: int, num_edges: int, device) -> bool:
    """Densify the per-step subgraphs of ``n`` nodes and ``num_edges``
    sampled edges on ``device``? 'off' never, nor for a pair without a
    dense route; 'on' whenever N^2 fits (``0 < n <= dense_threshold`` and
    N^2 < 2**31, the flat ids' range); 'auto' also needs enough edges to
    pay for the build (E >= 4N) and a device type in
    ``AUTO_DEVICE_TYPES``."""
    if cfg.dense_subgraph == "off":
        return False
    if not dense_supported(cfg.GNN, cfg.edge_mlp_type):
        return False
    ok = 0 < n <= cfg.dense_threshold and n * n < 2 ** 31
    if cfg.dense_subgraph == "on":
        return ok
    return ok and num_edges >= 4 * n and \
        torch.device(device).type in AUTO_DEVICE_TYPES

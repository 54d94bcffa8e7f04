"""Graph partitioning into cluster mini-batches (port of the JAX package's
``data/partition.py``).

As the reference's ClusterData (keep_inter_cluster_edges=False): nodes are
split into ``num_parts`` sets, each batch is the induced subgraph on one
part with relabeled node ids, and edges between parts are dropped.

  * ``partition_nodes``: reverse-Cuthill-McKee order chunked into balanced
    parts ('rcm'), the native C++ partitioner ('native', falling back to
    'rcm' when its library cannot be built or loaded), or shuffled chunks
    ('random'). ``resolve_partitioner`` says which one a request runs.
  * ``induced_subgraphs``: one port ``Graph`` per part on the requested
    device, with a ghost node for padding edges, the degree prior per part,
    edge counts padded to at most ``shape_classes`` shapes and one
    ``receiver_band`` for all.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..core.graph import Graph
from .priors import degree_prior


def resolve_partitioner(method: str) -> str:
    """The method ``partition_nodes(..., method)`` runs: 'native' becomes
    'rcm' when the native library cannot be built or loaded."""
    if method == "native":
        try:
            from .native_partitioner import _load
            _load()
        except (ImportError, OSError):
            return "rcm"
    return method


def partition_nodes(edge_index: np.ndarray, num_nodes: int, num_parts: int,
                    method: str = "rcm") -> np.ndarray:
    """Assign each node to one of ``num_parts`` clusters; int32 part ids.

    'rcm'    bandwidth-reducing reverse-Cuthill-McKee order, chunked.
    'native' C++ greedy partitioner (native/partitioner.cpp) if it builds.
    'random' shuffled chunking (worst-case baseline).
    """
    if num_parts <= 1:
        return np.zeros(num_nodes, np.int32)
    method = resolve_partitioner(method)
    if method == "native":
        from .native_partitioner import greedy_partition
        return greedy_partition(edge_index, num_nodes, num_parts)
    if method == "rcm":
        a = sp.coo_matrix((np.ones(edge_index.shape[1]),
                           (edge_index[0], edge_index[1])),
                          shape=(num_nodes, num_nodes))
        a = ((a + a.T) > 0).astype(np.int8).tocsr()
        order = sp.csgraph.reverse_cuthill_mckee(a, symmetric_mode=True)
    elif method == "random":
        order = np.random.default_rng(0).permutation(num_nodes)
    else:
        raise ValueError(method)
    part = np.empty(num_nodes, np.int32)
    bounds = np.linspace(0, num_nodes, num_parts + 1).astype(np.int64)
    for p in range(num_parts):
        part[order[bounds[p]:bounds[p + 1]]] = p
    return part


def shape_class_targets(counts, k: int) -> List[int]:
    """Per-partition padded edge targets using at most ``k`` shape classes,
    the boundaries minimising sum(class size x class max) exactly (dynamic
    programme over the sorted counts)."""
    m = len(counts)
    k = max(1, min(k, m))
    order = np.argsort(counts)[::-1]
    c = np.asarray(counts)[order]
    # dp[j][i] = min padded total for the first i partitions with j classes
    inf = float("inf")
    dp = np.full((k + 1, m + 1), inf)
    cut = np.zeros((k + 1, m + 1), np.int64)
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(1, m + 1):
            for b in range(j - 1, i):      # previous boundary
                v = dp[j - 1][b] + float(c[b]) * (i - b)
                if v < dp[j][i]:
                    dp[j][i] = v
                    cut[j][i] = b
    jbest = int(np.argmin([dp[j][m] for j in range(1, k + 1)])) + 1
    bounds = []
    i = m
    for j in range(jbest, 0, -1):
        bounds.append(int(cut[j][i]))
        i = bounds[-1]
    bounds = bounds[::-1] + [m]
    targets = np.zeros(m, np.int64)
    for a, b in zip(bounds[:-1], bounds[1:]):
        targets[order[a:b]] = c[a]
    return [int(t) for t in targets]


def part_edge_ids(part_s: np.ndarray, part_r: np.ndarray,
                  num_parts: int) -> List[np.ndarray]:
    """The ids of the edges inside each part (both endpoints in part p),
    ascending, for p < ``num_parts``: what ``np.where((part_s == part_r) &
    (part_s == p))`` gives, from one stable grouping of the kept edges
    instead of one pass over every edge per part."""
    kept = np.flatnonzero(part_s == part_r)
    keys = part_s[kept]
    # a stable sort keeps each part's ids ascending
    kept = kept[np.argsort(keys, kind="stable")]
    counts = np.bincount(keys, minlength=num_parts)[:num_parts]
    ends = np.cumsum(counts)
    return [kept[a:b] for a, b in zip(ends - counts, ends)]


def induced_subgraphs(x, edge_index, y, train_mask, val_mask, test_mask,
                      part: np.ndarray, num_parts: int,
                      pad: bool = True, prior: str = "degree",
                      prior_probs: Optional[np.ndarray] = None,
                      tile_index: bool = False, shape_classes: int = 1,
                      device="cuda") -> List[Graph]:
    """One ``Graph`` per partition on ``device``: induced subgraph,
    relabeled nodes, inter-cluster edges dropped. With ``pad`` the node
    count pads to the global max + 1 (the ghost node, ``max_n - 1``, takes
    every padding edge as a self-loop) and the edge count to its shape
    class's max (``shape_class_targets``). The sampling prior is computed
    per batch from the batch's own edges, as the reference's ClusterLoader
    slices ``batch.prob``."""
    s_all, r_all = edge_index
    out = []
    max_n = int(np.bincount(part, minlength=num_parts)[:num_parts].max()) + 1
    per_part_edges = part_edge_ids(part[s_all], part[r_all], num_parts)
    counts_e = [len(e) for e in per_part_edges]
    pad_targets = shape_class_targets(counts_e, shape_classes) if pad \
        else [None] * num_parts

    for p in range(num_parts):
        nodes = np.where(part == p)[0]
        relabel = -np.ones(len(part), np.int64)
        relabel[nodes] = np.arange(len(nodes))
        eidx = per_part_edges[p]
        s = relabel[s_all[eidx]].astype(np.int32)
        r = relabel[r_all[eidx]].astype(np.int32)
        n_local, e_local = len(nodes), len(eidx)

        xb = x[nodes]
        yb = y[nodes]
        tr, va, te = train_mask[nodes], val_mask[nodes], test_mask[nodes]
        if prior_probs is not None:
            pb = prior_probs[eidx]
            pb = pb / max(pb.sum(), 1e-12)
        elif prior == "degree":
            pb = degree_prior(s, r, n_local)
        else:
            pb = np.full(e_local, 1.0 / max(e_local, 1), np.float32)

        if pad:
            pad_n = max_n - n_local
            xb = np.concatenate([xb, np.zeros((pad_n, x.shape[1]),
                                              x.dtype)])
            yb = np.concatenate([yb, np.zeros(pad_n, y.dtype)])
            tr = np.concatenate([tr, np.zeros(pad_n, bool)])
            va = np.concatenate([va, np.zeros(pad_n, bool)])
            te = np.concatenate([te, np.zeros(pad_n, bool)])
        out.append(Graph.build(xb, np.stack([s, r]), yb, tr, va, te,
                               prob=pb, num_classes=int(y.max()) + 1,
                               pad_edges_to=pad_targets[p],
                               pad_edge_node=max_n - 1 if pad else 0,
                               sort_by_receiver=True, tile_index=tile_index,
                               device=device))
    # one band for every partition, as the JAX package unifies it for one
    # compiled step (here: one kernel variant)
    max_band = max(g.receiver_band for g in out)
    out = [dataclasses.replace(g, receiver_band=max_band) for g in out]
    if tile_index:
        # unify tile slot counts within each padded-edge class
        by_cls = {}
        for i, g in enumerate(out):
            by_cls.setdefault(g.num_edges, []).append(i)
        for idxs in by_cls.values():
            unified = unify_tile_shapes([out[i] for i in idxs])
            for i, g in zip(idxs, unified):
                out[i] = g
    return out


_NO_TILES = dict(tile_ls=None, tile_lr=None, tile_su=None, tile_rv=None,
                 tile_perm=None, tile_prob=None, tile_mask=None,
                 tile_aux=None, tile_t=0, tile_b=0)


def unify_tile_shapes(graphs: List[Graph]) -> List[Graph]:
    """Pad every partition's tile-pair index to one shared slot count.

    If any partition declined the tile layout (padded slots above 1.35 E,
    ``ops/score_tiles.build_tile_index``), tiles are dropped on all of
    them, as in the JAX package. Padding blocks address tile (0, 0) with
    local ids 0, invalid flags and zero prior, so the tile-space sampler
    never draws them."""
    if not graphs:
        return graphs
    if any(g.tile_t == 0 for g in graphs):
        return [dataclasses.replace(g, **_NO_TILES) for g in graphs]
    b = graphs[0].tile_b
    max_ep = max(g.tile_ls.shape[0] for g in graphs)
    out = []
    for g in graphs:
        pe = max_ep - g.tile_ls.shape[0]
        if pe == 0:
            out.append(g)
            continue

        def cat(a, n, shape=()):
            return torch.cat([a, torch.zeros((n,) + shape, dtype=a.dtype,
                                             device=a.device)])

        out.append(dataclasses.replace(
            g, tile_ls=cat(g.tile_ls, pe), tile_lr=cat(g.tile_lr, pe),
            tile_su=cat(g.tile_su, pe // b), tile_rv=cat(g.tile_rv, pe // b),
            tile_perm=cat(g.tile_perm, pe), tile_prob=cat(g.tile_prob, pe),
            tile_mask=cat(g.tile_mask, pe),
            tile_aux=cat(g.tile_aux, pe, (3,))))
    return out

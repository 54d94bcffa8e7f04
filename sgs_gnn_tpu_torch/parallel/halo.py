"""Halo SpMM over partitioned storage, the all-gather reference (port of
``parallel/halo.py``).

The reference's cluster batching drops inter-cluster edges, as
``parallel/partitioned.py`` does. The halo route keeps them: each rank
owns a node shard and ALL edges arriving at its nodes, and the rows of
sender nodes that live on other ranks ("halo" nodes) are exchanged before
the local aggregation, so the partitioned computation is the full-graph
one. This module is v1 of the exchange, kept as the reference as in JAX:
every rank all-gathers every shard's rows. ``parallel/halo_train.py``
holds v2, which ships only the boundary rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.edge_gather import gather_rows
from ..ops.scatter import scatter_add
from .mesh import Mesh


class HaloPartition(NamedTuple):
    """Host tables of the halo aggregation, one row per rank.

    node_map[d]      : global ids of rank d's nodes (padded with -1)
    senders_glob[d]  : global sender id of each edge arriving at rank d
    receivers_loc[d] : local receiver index of each such edge
    edge_mask[d]     : validity of each (padded) edge slot
    """
    node_map: np.ndarray       # (D, N_loc)
    senders_glob: np.ndarray   # (D, E_loc)
    receivers_loc: np.ndarray  # (D, E_loc)
    edge_mask: np.ndarray      # (D, E_loc)
    num_nodes: int


def build_halo_partition(edge_index: np.ndarray, part: np.ndarray,
                         num_parts: int) -> HaloPartition:
    """The tables of ``part`` (node -> rank): node shards padded to the
    largest, each rank's inbound edges (inter-partition ones included)
    padded to the largest count."""
    n = len(part)
    s_all, r_all = edge_index
    nodes = [np.where(part == p)[0] for p in range(num_parts)]
    n_loc = max(len(v) for v in nodes)
    local_of = -np.ones(n, np.int64)
    for p in range(num_parts):
        local_of[nodes[p]] = np.arange(len(nodes[p]))
    edge_sets = [np.where(part[r_all] == p)[0] for p in range(num_parts)]
    e_loc = max(len(v) for v in edge_sets)
    node_map = np.full((num_parts, n_loc), -1, np.int32)
    senders = np.zeros((num_parts, e_loc), np.int32)
    receivers = np.zeros((num_parts, e_loc), np.int32)
    emask = np.zeros((num_parts, e_loc), bool)
    for p in range(num_parts):
        node_map[p, :len(nodes[p])] = nodes[p]
        eidx = edge_sets[p]
        senders[p, :len(eidx)] = s_all[eidx]
        receivers[p, :len(eidx)] = local_of[r_all[eidx]]
        emask[p, :len(eidx)] = True
    return HaloPartition(node_map, senders, receivers, emask, n)


def shard_features(x: np.ndarray, hp: HaloPartition) -> np.ndarray:
    """(D, N_loc, F) feature shards following the node map (zero
    padding)."""
    d, n_loc = hp.node_map.shape
    out = np.zeros((d, n_loc, x.shape[1]), x.dtype)
    for p in range(d):
        valid = hp.node_map[p] >= 0
        out[p, valid] = x[hp.node_map[p][valid]]
    return out


def make_halo_spmm(hp: HaloPartition, mesh: Mesh):
    """``halo_spmm(x_local, w_local) -> y_local``: this rank's rows of the
    full graph's weighted SpMM, ``x_local`` (N_loc, F) its shard,
    ``w_local`` (E_loc,) its inbound edges' weights. Every rank
    all-gathers every shard (v1); the sum is local (gather + K1)."""
    d, n_loc = hp.node_map.shape
    if mesh.world != d:
        raise ValueError(f"halo partition built for {d} ranks, the group "
                         f"has {mesh.world}")
    flat_of_global = np.zeros(hp.num_nodes, np.int64)
    for p in range(d):
        valid = hp.node_map[p] >= 0
        flat_of_global[hp.node_map[p][valid]] = (
            p * n_loc + np.arange(n_loc)[valid])
    me = mesh.rank
    dev = mesh.device
    src = torch.as_tensor(flat_of_global[hp.senders_glob[me]]
                          .astype(np.int32), device=dev)
    dst = torch.as_tensor(hp.receivers_loc[me], device=dev)
    mask = torch.as_tensor(hp.edge_mask[me], device=dev)

    def halo_spmm(x_local: torch.Tensor, w_local: torch.Tensor):
        parts = [torch.empty_like(x_local) for _ in range(d)]
        dist.all_gather(parts, x_local.contiguous())
        x_all = torch.cat(parts)                       # (D * N_loc, F)
        w = torch.where(mask, w_local.float(), 0.0)
        msgs = gather_rows(x_all, src).float() * w[:, None]
        return scatter_add(msgs, dst, n_loc)

    return halo_spmm

"""Graph container of torch tensors on an explicit device (port of
``core/graph.py``).

Conventions as in the JAX package: a COO edge list ``senders`` /
``receivers`` (E,) int32 with messages flowing sender -> receiver; padding
edges are self-loops on ``pad_edge_node`` with ``edge_mask=False`` and zero
prior. ``Graph.build`` takes host numpy arrays and applies the same padding,
stable receiver sort, ``receiver_band`` and packed ``edge_aux`` table as the
JAX ``Graph.build``. The tile-index fields of the fused tile-pair score
kernel are built by the training slice; ``build`` leaves them ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from ..ops.scatter import required_band


@dataclasses.dataclass(frozen=True)
class Graph:
    """One graph (or one cluster partition); all tensors on one device.

    ``receiver_band`` > 0 records that ``receivers`` is non-decreasing with
    that narrow-band bound (``ops.scatter.required_band``)."""

    x: torch.Tensor            # (N, F) float32 node features
    senders: torch.Tensor      # (E,) int32 edge sources
    receivers: torch.Tensor    # (E,) int32 edge destinations
    y: torch.Tensor            # (N,) int32 labels
    train_mask: torch.Tensor   # (N,) bool
    val_mask: torch.Tensor     # (N,) bool
    test_mask: torch.Tensor    # (N,) bool
    prob: torch.Tensor         # (E,) float32 sampling prior
    edge_mask: torch.Tensor    # (E,) bool; False on padding edges
    # tile-pair index of the fused full-E score kernel (training slice)
    tile_ls: Optional[torch.Tensor] = None
    tile_lr: Optional[torch.Tensor] = None
    tile_su: Optional[torch.Tensor] = None
    tile_rv: Optional[torch.Tensor] = None
    tile_perm: Optional[torch.Tensor] = None
    tile_prob: Optional[torch.Tensor] = None
    tile_mask: Optional[torch.Tensor] = None
    # (E, 3) int32 [sender, receiver, flags]: bit0 = both endpoints train,
    # bit1 = same label, bit2 = valid (edge_mask)
    edge_aux: Optional[torch.Tensor] = None
    tile_aux: Optional[torch.Tensor] = None
    num_classes: int = 0
    receiver_band: int = 0
    tile_t: int = 0
    tile_b: int = 0

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @staticmethod
    def build(x, edge_index, y, train_mask=None, val_mask=None,
              test_mask=None, prob=None, num_classes: Optional[int] = None,
              pad_edges_to: Optional[int] = None, pad_edge_node: int = 0,
              sort_by_receiver: bool = False, device="cuda") -> "Graph":
        """Construct from host numpy arrays on ``device``, optionally
        padding the edge list and stably sorting it by receiver (all
        per-edge arrays permuted together)."""
        dev = resolve_device(device)
        x = np.asarray(x, dtype=np.float32)
        edge_index = np.asarray(edge_index, dtype=np.int32)
        n, e = x.shape[0], edge_index.shape[1]
        y = np.asarray(y, dtype=np.int32).reshape(-1)
        if num_classes is None:
            num_classes = int(y.max()) + 1 if y.size else 0
        zeros = np.zeros(n, dtype=bool)
        train_mask = zeros if train_mask is None else np.asarray(train_mask,
                                                                 bool)
        val_mask = zeros if val_mask is None else np.asarray(val_mask, bool)
        test_mask = zeros if test_mask is None else np.asarray(test_mask,
                                                               bool)
        if prob is None:
            prob = np.full(e, 1.0 / max(e, 1), dtype=np.float32)
        prob = np.asarray(prob, dtype=np.float32)

        edge_mask = np.ones(e, dtype=bool)
        if pad_edges_to is not None and pad_edges_to > e:
            pad = pad_edges_to - e
            edge_index = np.concatenate(
                [edge_index,
                 np.full((2, pad), pad_edge_node, dtype=np.int32)], axis=1)
            prob = np.concatenate([prob, np.zeros(pad, dtype=np.float32)])
            edge_mask = np.concatenate([edge_mask, np.zeros(pad, dtype=bool)])

        receiver_band = 0
        if sort_by_receiver and edge_index.shape[1]:
            order = np.argsort(edge_index[1], kind="stable")
            edge_index = edge_index[:, order]
            prob = prob[order]
            edge_mask = edge_mask[order]
            receiver_band = required_band(edge_index[1])

        s_, r_ = edge_index[0], edge_index[1]
        both_train = train_mask[s_] & train_mask[r_]
        same_label = y[s_] == y[r_] if y.size else np.zeros(e, bool)
        flags = (both_train.astype(np.int32)
                 | (same_label.astype(np.int32) << 1)
                 | (edge_mask.astype(np.int32) << 2))
        edge_aux = np.stack([s_, r_, flags], axis=1).astype(np.int32)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        return Graph(
            x=t(x), senders=t(s_), receivers=t(r_), y=t(y),
            train_mask=t(train_mask), val_mask=t(val_mask),
            test_mask=t(test_mask), prob=t(prob), edge_mask=t(edge_mask),
            edge_aux=t(edge_aux), num_classes=int(num_classes),
            receiver_band=int(receiver_band))

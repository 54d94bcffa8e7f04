"""Row gather (port of ``ops/edge_gather.py``, forward only).

``gather_rows(table, idx) == table[idx]``. The JAX module exists for its
backward (a scatter-add of the row gradients); that comes with the
training slice, as an autograd ``Function`` over ``scatter_add``.
"""
from __future__ import annotations

import torch


def gather_rows(table, idx):
    """table[idx] for an (E,) int32 or int64 index."""
    return torch.index_select(table, 0, idx)

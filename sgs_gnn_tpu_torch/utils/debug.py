"""Debug checks (port of ``utils/debug.py``), run by ``--debug_checks``.

  * ``validate_graph``: host-side structural invariants of a ``Graph``
    batch (index bounds, disjoint masks, the prior, the labels, the
    receiver band), on numpy copies; ``run_experiment`` runs it once per
    batch after ``prepare_batches``, off the training path.
  * ``checked``: wraps a function so that its call synchronizes the card
    (a device-side assert then surfaces at the call) and raises on
    non-finite floating outputs: the counterpart of checkify's NaN checks
    (its index checks are ``validate_graph``'s).
  * ``find_nans``: the paths of non-finite tensors in nested dicts, lists
    and tuples, for post-mortems.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from ..ops.scatter import required_band


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def validate_graph(g, name: str = "graph") -> None:
    """Raise ValueError on a malformed ``Graph`` batch."""
    n, e = g.num_nodes, g.num_edges
    s, r = _host(g.senders), _host(g.receivers)
    problems = []
    if s.min(initial=0) < 0 or s.max(initial=0) >= n:
        problems.append(f"senders out of range [0,{n})")
    if r.min(initial=0) < 0 or r.max(initial=0) >= n:
        problems.append(f"receivers out of range [0,{n})")
    tm, vm, te = _host(g.train_mask), _host(g.val_mask), _host(g.test_mask)
    if (tm & vm).any() or (vm & te).any() or (tm & te).any():
        problems.append("train/val/test masks overlap")
    prob = _host(g.prob)
    if not np.isfinite(prob).all() or (prob < 0).any():
        problems.append("prior has negative or non-finite entries")
    if prob[~_host(g.edge_mask)].sum() > 1e-6:
        problems.append("padding edges carry prior probability")
    y = _host(g.y)
    if g.num_classes and (y.min() < 0 or y.max() >= g.num_classes):
        problems.append(f"labels out of range [0,{g.num_classes})")
    if g.receiver_band:
        # a band below the ids' own makes the banded sorted scatter (K7)
        # drop contributions (ops/scatter.py sorted_band_keep)
        if e and (np.diff(r) < 0).any():
            problems.append("receiver_band set but receivers are not sorted")
        elif e and required_band(r) > g.receiver_band:
            problems.append(
                f"receiver_band={g.receiver_band} < required_band="
                f"{required_band(r)}; banded scatter would drop "
                "contributions")
    if problems:
        raise ValueError(f"{name}: " + "; ".join(problems))


def _tensors(tree: Any, path: str = ""):
    """(path, tensor) of every tensor in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}" if path else str(i))


def find_nans(tree: Any) -> List[str]:
    """Paths of the floating tensors in ``tree`` that hold a NaN or an
    infinity."""
    return [p for p, t in _tensors(tree)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped: each call synchronizes the devices of its output
    tensors, then raises FloatingPointError if a floating output holds a
    NaN or an infinity."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for dev in {t.device for _, t in _tensors(out)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        bad = find_nans(out)
        if bad:
            raise FloatingPointError(
                f"{getattr(fn, '__name__', 'fn')}: non-finite values in "
                f"{[p or 'the output' for p in bad]}")
        return out

    return wrapper

"""Checkpoint / resume (port of ``run/checkpoint.py``).

The whole training state round-trips through one ``torch.save`` file: the
model's ``state_dict``, the ``DualOptimizer`` group states (moments and
step counts per group), the epoch, the best-val bookkeeping and
temperature, the losses, the best-val ``state_dict`` and the F1 curves, so
a resumed run reports the same curves as one that was never stopped. The
file is written to a temporary name and moved into place with
``os.replace``: a crash never leaves a torn checkpoint. Tensors are saved
on the CPU and restored onto the run's device.

The JAX package's ``save_checkpoint_orbax`` writes orbax's format, a JAX
format; it has no counterpart here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]       # model.state_dict()
    opt_state: Dict[str, dict]            # DualOptimizer.state_dict()
    epoch: int = 0
    best_val_f1: float = 0.0
    test_at_best_val: float = 0.0
    best_temperature: float = 0.0
    losses: list = field(default_factory=list)
    # the best-val parameters: without them a resumed run that never beats
    # the restored best_val_f1 would report its final eval on the last
    # checkpoint's parameters
    best_params: Optional[Dict[str, torch.Tensor]] = None
    best_test_f1: float = 0.0
    train_curve: list = field(default_factory=list)
    val_curve: list = field(default_factory=list)
    test_curve: list = field(default_factory=list)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def save_checkpoint(path: str, state: TrainState) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: _cpu(v) for k, v in vars(state).items()}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device="cpu") -> Optional[TrainState]:
    """The state saved at ``path`` with its tensors on ``device``; None if
    there is no checkpoint."""
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location=device, weights_only=True)
    return TrainState(**payload)

"""Move parameters from the JAX package's flax tree into the port.

The flax tree of the GCN backbone with the GCN scorer is

    params/{gcn1,gcn2}/{lin/kernel (in, out), bias}
    params/edge_prob_mlp/{gcn1,gcn2}/{lin/kernel, bias}
    params/edge_prob_mlp/head/fc1/{kernel (2F, K), bias (K,)}
    params/edge_prob_mlp/head/fc2/{kernel (K, 1), bias (1,)}

and the port's module tree has the same names, with ``nn.Linear`` weights
in place of kernels: a flax kernel is (in, out), a ``Linear.weight`` is
(out, in), so kernels are transposed and renamed ``weight``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port from the flax parameter tree, given as
    nested dicts of numpy arrays (with or without the top ``params`` key).
    Load it with ``model.load_state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            out[".".join(prefix + (key,))] = torch.tensor(arr)

    walk(tree, ())
    return out

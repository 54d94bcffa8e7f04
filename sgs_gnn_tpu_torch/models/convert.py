"""Move parameters from the JAX package's flax tree into the port.

The flax tree of a backbone is ``params/{<backbone layers>, edge_prob_mlp}``
with, per layer (kernels (in, out), biases (out,)):

    GCNConv   gcn1, gcn2 (GCN backbone; GCN scorer's encoder):
              lin/kernel, bias
    ChebConv  gcn1, gcn2 (Cheb backbone, K=1): lins_0/kernel, bias
              (K > 1 adds lins_1/kernel ... lins_{K-1}/kernel)
    GINConv   GIN_conv1, GIN_conv2: mlp_lin1/{kernel, bias},
              mlp_lin2/{kernel, bias}
    GATConv   GAT_conv1, GAT_conv2: lin/kernel (in, H*F), att_src (1, H, F),
              att_dst (1, H, F), bias (H*F,) concatenated or (F,) averaged
    SAGEConv  edge_prob_mlp/gcn1 (GSAGE scorer): lin_l/{kernel, bias},
              lin_r/kernel

and the scorer's own parameters

    edge_prob_mlp/head/fc1/{kernel (2F, K), bias (K,)}
    edge_prob_mlp/head/fc2/{kernel (K, 1), bias (1,)}
    edge_prob_mlp/fcdim/{kernel, bias}             (MLP scorer)
    edge_prob_mlp/{gcn1, gcn2}/...                 (GCN scorer: GCNConv)

The port's module tree has the same names, with ``nn.Linear`` weights in
place of kernels: a flax kernel is (in, out), a ``Linear.weight`` is
(out, in), so kernels are transposed and renamed ``weight``. Every other
leaf (biases, ``att_src``, ``att_dst``) keeps its shape.
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

"""The comparison baselines (port of ``baselines/``): NeuralSparse's
k-per-node Gumbel selection and SparseGAT's L0-gated attention."""
from .neuralsparse import NeuralSparseGCN, per_node_topk_mask
from .sparsegat import SparseGAT, l0_penalty

__all__ = ["NeuralSparseGCN", "per_node_topk_mask", "SparseGAT",
           "l0_penalty"]

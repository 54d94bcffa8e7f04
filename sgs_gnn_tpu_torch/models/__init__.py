from .backbones import GNNModel, get_model
from .convert import params_from_jax
from .layers import GCNConv
from .scorers import EdgeProbGCN

__all__ = ["GNNModel", "get_model", "params_from_jax", "GCNConv",
           "EdgeProbGCN"]

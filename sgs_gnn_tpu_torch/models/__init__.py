from .backbones import ChebModel, GATModel, GINModel, GNNModel, get_model
from .convert import params_from_jax
from .layers import ChebConv, GATConv, GCNConv, GINConv, SAGEConv
from .scorers import EdgeProbGCN, EdgeProbMLP, EdgeProbSAGE, get_edge_mlp

__all__ = ["GNNModel", "GINModel", "GATModel", "ChebModel", "get_model",
           "params_from_jax", "GCNConv", "SAGEConv", "GATConv", "GINConv",
           "ChebConv", "EdgeProbGCN", "EdgeProbMLP", "EdgeProbSAGE",
           "get_edge_mlp"]

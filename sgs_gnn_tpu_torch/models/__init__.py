from .backbones import (ChebModel, GATModel, GCNIIModel, GINModel, GNNModel,
                        get_model)
from .convert import params_from_jax
from .layers import (ChebConv, GATConv, GCN2Conv, GCNConv, GINConv,
                     SAGEConv)
from .scorers import EdgeProbGCN, EdgeProbMLP, EdgeProbSAGE, get_edge_mlp

__all__ = ["GNNModel", "GINModel", "GATModel", "ChebModel", "GCNIIModel",
           "get_model", "params_from_jax", "GCNConv", "SAGEConv", "GATConv",
           "GINConv", "ChebConv", "GCN2Conv", "EdgeProbGCN", "EdgeProbMLP",
           "EdgeProbSAGE", "get_edge_mlp"]

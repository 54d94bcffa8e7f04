"""Plots and drawings of a run (port of ``viz/``): the learning curves,
the edge probability plots, node embeddings reduced to 2-D, and the full
and sampled graphs side by side."""
from .curves import plot_hist, plot_learning_curves, plot_probs
from .embeddings import extract_embeddings, plot_embeddings_2d, reduce_2d
from .graphs import (count_edges_with_different_labels,
                     visualize_graphs_side_by_side)

__all__ = [
    "extract_embeddings", "reduce_2d", "plot_embeddings_2d",
    "plot_learning_curves", "plot_probs", "plot_hist",
    "visualize_graphs_side_by_side", "count_edges_with_different_labels",
]

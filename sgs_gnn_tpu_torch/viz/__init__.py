"""Plots of a run (port of ``viz/``): the learning curves and the edge
probability plots. The embedding and graph drawings (``viz/embeddings.py``,
``viz/graphs.py``) are not ported yet."""
from .curves import plot_hist, plot_learning_curves, plot_probs

__all__ = ["plot_learning_curves", "plot_probs", "plot_hist"]

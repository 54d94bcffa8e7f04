"""Embedding extraction and 2-D reduction for figures (port of
``viz/embeddings.py``; reference visualization_utils/embeddings.py).

``extract_embeddings`` runs on the model's device; the reduction and the
plot are host code, copies of the JAX module's, with sklearn and
matplotlib imported at first use. Offline analysis only: never on the
train path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .curves import _plt, _save

_FIRST_LAYERS = ("gcn1", "GIN_conv1", "GAT_conv1")


@torch.no_grad()
def extract_embeddings(model, graph, layer: str = "hidden") -> np.ndarray:
    """Node embeddings as numpy: ``'hidden'``, the backbone's first conv
    (``gcn1``, ``GIN_conv1`` or ``GAT_conv1``) then ReLU, the analogue of
    the reference's ``model.gcn1`` hook; ``'logits'``, the whole forward
    in evaluation semantics. Runs on the model's device (the graph's
    tensors are moved there)."""
    dev = next(model.parameters()).device
    x, s, r = (t.to(dev) for t in (graph.x, graph.senders, graph.receivers))
    if layer == "logits":
        out = model(x, s, r, deterministic=True)
    elif layer == "hidden":
        conv = next(getattr(model, n) for n in _FIRST_LAYERS
                    if hasattr(model, n))
        out = torch.relu(conv(x, s, r))
    else:
        raise ValueError(f"layer={layer!r} must be 'hidden' or 'logits'")
    return out.float().cpu().numpy()


def reduce_2d(embeddings: np.ndarray, method: str = "pca",
              seed: int = 0) -> np.ndarray:
    """PCA or t-SNE to 2 dims (reference visualization_utils/utils.py)."""
    if method == "pca":
        from sklearn.decomposition import PCA
        return PCA(n_components=2, random_state=seed).fit_transform(embeddings)
    if method == "tsne":
        from sklearn.manifold import TSNE
        return TSNE(n_components=2, random_state=seed,
                    init="pca").fit_transform(embeddings)
    raise ValueError(method)


def plot_embeddings_2d(embeddings_2d: np.ndarray, labels: np.ndarray,
                       title: str = "", path: Optional[str] = None,
                       mask: Optional[np.ndarray] = None):
    """Scatter of 2-D embeddings coloured by label (``mask`` keeps a
    subset); saved to ``path`` (returned) or returned as the figure."""
    plt = _plt()
    if mask is not None:
        embeddings_2d, labels = embeddings_2d[mask], labels[mask]
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(embeddings_2d[:, 0], embeddings_2d[:, 1], c=labels,
                    cmap="tab10", s=6, alpha=0.7)
    ax.set_title(title)
    fig.colorbar(sc, ax=ax, shrink=0.8)
    return _save(plt, fig, path, bbox_inches="tight")

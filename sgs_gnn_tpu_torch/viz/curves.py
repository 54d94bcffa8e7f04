"""Learning-curve and probability plots (port of ``viz/curves.py``;
reference utils.py:91-160, 403-415). matplotlib is imported at the first
plot, with the headless Agg backend; every function saves to ``path``
when one is given (and returns it), else returns the figure."""
from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(plt, fig, path, **kw):
    if path:
        fig.savefig(path, dpi=150, **kw)
        plt.close(fig)
        return path
    return fig


def plot_learning_curves(run: int, train_f1, val_f1, test_f1,
                         path: Optional[str] = None):
    """Train / val / test micro-F1 per epoch of one run (the driver's
    ``--plot_curve``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    xs = np.arange(len(train_f1))
    ax.plot(xs, train_f1, label="train")
    ax.plot(xs, val_f1, label="val")
    ax.plot(xs, test_f1, label="test")
    ax.set_xlabel("epoch")
    ax.set_ylabel("micro-F1")
    ax.set_title(f"run {run}")
    ax.legend()
    ax.grid(True, alpha=0.3)
    return _save(plt, fig, path, bbox_inches="tight")


def plot_probs(edge_probs, sampling_probs, path: Optional[str] = None):
    """Scatter of per-edge learned probabilities and the sampling
    distribution (reference utils.py:91-115)."""
    plt = _plt()
    ep, sp = np.asarray(edge_probs), np.asarray(sampling_probs)
    fig, axes = plt.subplots(2, 1, figsize=(16, 6))
    for ax, v, title in ((axes[0], ep, "Edge Probs"),
                         (axes[1], sp, "Sampling Probs")):
        ax.scatter(range(len(v)), v, s=2)
        ax.set_title(title)
        ax.grid(True)
    fig.tight_layout()
    return _save(plt, fig, path)


def plot_hist(edge_probs, sampling_probs, ep_selected, sp_selected,
              path: Optional[str] = None):
    """Four histograms: all and selected edge and sampling probabilities
    (reference utils.py:118-160)."""
    plt = _plt()
    panels = [(edge_probs, "Edge Probs"),
              (sampling_probs, "Sampling Probs"),
              (ep_selected, "Selected Edge Probs"),
              (sp_selected, "Selected Sampling Probs")]
    fig, axes = plt.subplots(4, 1, figsize=(16, 12))
    for ax, (v, title) in zip(axes, panels):
        ax.hist(np.asarray(v), bins=30, edgecolor="black")
        ax.set_title(title)
        ax.grid(True)
    fig.tight_layout()
    return _save(plt, fig, path)

"""Full-versus-sampled graph drawings and the heterophily count (port of
``viz/graphs.py``; reference utils.py:291-398,
visualization_utils/graph.py). Host code, a copy of the JAX module's, with
matplotlib and networkx imported at first use."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .curves import _plt, _save


def count_edges_with_different_labels(senders, receivers, y):
    """Heterophilic-edge count of a (sub)graph (reference utils.py:291-342,
    the homophily of the sampled graph against the original's)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    y = np.asarray(y)
    diff = int(np.sum(y[senders] != y[receivers]))
    total = len(senders)
    return {"different": diff, "same": total - diff, "total": total,
            "heterophily": diff / total if total else 0.0}


def visualize_graphs_side_by_side(full_edges, sampled_edges, y, pos=None,
                                  max_nodes: int = 300,
                                  path: Optional[str] = None):
    """The full graph and the sampled subgraph side by side, nodes
    coloured by label (reference ``visualize``, utils.py:370-398); only
    the first ``max_nodes`` nodes are drawn."""
    import networkx as nx
    plt = _plt()
    y = np.asarray(y)
    n = min(len(y), max_nodes)

    def build(es):
        g = nx.Graph()
        g.add_nodes_from(range(n))
        s, r = np.asarray(es[0]), np.asarray(es[1])
        keep = (s < n) & (r < n)
        g.add_edges_from(zip(s[keep].tolist(), r[keep].tolist()))
        return g

    g_full, g_samp = build(full_edges), build(sampled_edges)
    if pos is None:
        pos = nx.spring_layout(g_full, seed=0)
    fig, axes = plt.subplots(1, 2, figsize=(16, 7))
    for ax, g, title in ((axes[0], g_full, "full graph"),
                         (axes[1], g_samp, "sampled subgraph")):
        nx.draw(g, pos, ax=ax, node_color=y[:n], cmap="tab10",
                node_size=30, width=0.4, alpha=0.8)
        het = (count_edges_with_different_labels(
            *np.array(list(g.edges)).T.reshape(2, -1), y)
            if g.number_of_edges() else {"heterophily": 0.0})
        ax.set_title(f"{title} (het {het['heterophily']:.3f})")
    return _save(plt, fig, path, bbox_inches="tight")

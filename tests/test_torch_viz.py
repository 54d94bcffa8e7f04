"""The port's drawings (``sgs_gnn_tpu_torch/viz/``: the embeddings and the
graphs beside the curves) against the JAX package's: the twins of
``tests/test_aux.py``'s ``test_viz_smoke`` and ``test_extract_embeddings``.

``extract_embeddings`` runs the model (f32 on the CPU here; flax weights
moved by ``params_from_jax``) and is held to JAX's at rtol 1e-5 (atol
1e-6); the reduction, the heterophily count and the plots are host code,
held to JAX's exactly (PCA) or by what they write.
"""
import os

import jax
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.viz import (count_edges_with_different_labels as jax_count,
                             extract_embeddings as jax_extract,
                             reduce_2d as jax_reduce_2d)

from sgs_gnn_tpu_torch import Graph, get_model, params_from_jax
from sgs_gnn_tpu_torch.viz import (count_edges_with_different_labels,
                                   extract_embeddings, plot_embeddings_2d,
                                   plot_hist, plot_learning_curves,
                                   plot_probs, reduce_2d,
                                   visualize_graphs_side_by_side)

from test_torch_train import _np_tree
from test_train import _homophilous_graph


@pytest.fixture(autouse=True, scope="module")
def torch_defaults():
    """One intra-op thread (small CPU ops; parallel test workers share the
    cores) and float32 as the default dtype (another test module in the
    same worker sets float64 when it is imported)."""
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def _port_graph(jg):
    return Graph.build(np.asarray(jg.x), np.asarray(jg.edge_index),
                       np.asarray(jg.y), np.asarray(jg.train_mask),
                       np.asarray(jg.val_mask), np.asarray(jg.test_mask),
                       num_classes=jg.num_classes, device="cpu")


def test_viz_smoke(tmp_path):
    """test_aux.py:38's twin: every figure is written, the 2-D reduction
    has the embeddings' rows, the heterophily share lies in [0, 1]."""
    rng = np.random.default_rng(0)
    g = _homophilous_graph(rng, n=40)
    y = np.asarray(g.y)
    paths = [plot_learning_curves(0, [0.1, 0.5], [0.1, 0.4], [0.1, 0.3],
                                  path=str(tmp_path / "curves.png"))]
    probs = rng.uniform(0, 1, g.num_edges)
    paths.append(plot_probs(probs, probs / probs.sum(),
                            path=str(tmp_path / "p.png")))
    paths.append(plot_hist(probs, probs, probs[:10], probs[:10],
                           path=str(tmp_path / "h.png")))
    ei = np.asarray(g.edge_index)
    paths.append(visualize_graphs_side_by_side(
        ei, ei[:, :50], y, path=str(tmp_path / "g.png")))
    emb2 = reduce_2d(rng.normal(size=(40, 16)), "pca")
    assert emb2.shape == (40, 2)
    paths.append(plot_embeddings_2d(emb2, y, path=str(tmp_path / "e.png"),
                                    mask=y >= 0))
    for p in paths:
        assert os.path.getsize(p) > 0, p
    het = count_edges_with_different_labels(ei[0], ei[1], y)
    assert 0.0 <= het["heterophily"] <= 1.0


def test_count_edges_with_different_labels_equals_jax():
    """The same counts as JAX's on a graph and on a sampled subgraph; an
    empty edge list has heterophily 0."""
    rng = np.random.default_rng(1)
    g = _homophilous_graph(rng, n=50)
    ei, y = np.asarray(g.edge_index), np.asarray(g.y)
    for s, r in ((ei[0], ei[1]), (ei[0, ::7], ei[1, ::7]),
                 (ei[0, :0], ei[1, :0])):
        assert count_edges_with_different_labels(s, r, y) == \
            jax_count(s, r, y)


@pytest.mark.parametrize("method", ["pca", "tsne"])
def test_reduce_2d_equals_jax(method):
    """PCA and t-SNE from one seed give JAX's reduction (the same sklearn
    calls); an unknown method raises."""
    emb = np.random.default_rng(2).normal(size=(60, 8)).astype(np.float32)
    np.testing.assert_array_equal(reduce_2d(emb, method, seed=3),
                                  jax_reduce_2d(emb, method, seed=3))
    with pytest.raises(ValueError):
        reduce_2d(emb, "umap")


@pytest.mark.parametrize("gnn,scorer", [("GCN", "MLP"), ("GIN", "GSAGE"),
                                        ("GAT", "GCN")])
@pytest.mark.parametrize("layer", ["hidden", "logits"])
def test_extract_embeddings_equals_jax(gnn, scorer, layer):
    """test_aux.py:65's twin: the first conv + ReLU ('hidden': gcn1,
    GIN_conv1, GAT_conv1) and the whole forward ('logits') equal JAX's,
    f32, from the same weights; shapes (N, nhid) and (N, classes)."""
    rng = np.random.default_rng(0)
    jg = _homophilous_graph(rng, n=25)
    jm = jax_get_model(gnn, jg.x.shape[1], 12, jg.num_classes, 0.3, scorer)
    params = init_params(jm, jax.random.PRNGKey(0), jg.x, jg.senders,
                         jg.receivers)
    tm = get_model(gnn, jg.x.shape[1], 12, jg.num_classes, 0.3, scorer,
                   device="cpu")
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    want = jax_extract(jm, params, jg, layer=layer)
    got = extract_embeddings(tm, _port_graph(jg), layer=layer)
    assert got.shape == want.shape == (
        25, 12 if layer == "hidden" else jg.num_classes)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_extract_embeddings_refuses_an_unknown_layer():
    g = Graph.build(np.zeros((3, 2), np.float32),
                    np.array([[0, 1], [1, 2]], np.int32),
                    np.zeros(3, np.int32), device="cpu")
    m = get_model("GCN", 2, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="hidden"):
        extract_embeddings(m, g, layer="gcn2")

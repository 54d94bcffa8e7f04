"""Vendored raw-format dataset loaders (own copy of the JAX package's
``data/vendored.py``; ``has_vendored`` lives in ``core/config.py``, which
validates dataset names with it, and is re-exported here).

The reference vendors three on-disk raw formats inside its notebook loaders
(reference Notebooks/HeterophilousDataset.ipynb + Dataset.ipynb) so runs can
proceed from files instead of PyG downloads. This module reproduces those
formats as pure-numpy parsers (this container has zero egress, so files must
already sit under ``<data_dir>``):

* Facebook100 ``.mat`` (LINKXDataset._process_facebook): sparse adjacency
  ``A`` + integer ``local_info`` matrix; label = gender column - 1 (-1 means
  unlabeled), features = per-column one-hot of the remaining metadata.
  Covers penn94 / reed98 / amherst41 / cornell5 / johnshopkins55.
* geom-gcn text (WebKB / WikipediaNetwork / Actor raw files):
  ``out1_graph_edges.txt`` + ``out1_node_feature_label.txt``. Dense
  comma-separated features for texas/cornell/wisconsin/chameleon/squirrel;
  feature-INDEX lists for film/Actor (932-dim binary bag of keywords).
* LINKX film directory (Dataset.ipynb get_film): ``class_map.json`` +
  ``feats.npy`` + ``film_edges.csv``.
* LINKX cached-tensor directory (Dataset.ipynb cell 7 ``LINKXpyg2``):
  ``<data_dir>/LINKXdataset/<name>/{x.pt, edge_index.pt, y.pt}`` saved by
  torch — the reference's path to its largest benchmark graphs
  (wiki / pokec / arxiv-year / snap-patents / twitch-gamer). Masks follow
  LINKXpyg2's 0.6/0.2/0.2 split.
* GraphSAINT raw directory (Notebooks/RedditTwo.ipynb ``Reddit2.process``):
  ``adj_full.npz`` (CSR data/indices/indptr/shape) + ``feats.npy`` +
  ``class_map.json`` + ``role.json`` (tr/va/te index lists).

All loaders return ``(x, edge_index, y, masks_dict)`` in the registry's host
convention (float32 / int32 / int32, masks optional — the registry generates
the reference's 0.2/0.4/0.4 split when absent).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.config import has_vendored  # noqa: F401  (re-export)


def load_fb100_mat(path: str):
    """Facebook100 .mat → arrays (HeterophilousDataset.ipynb
    LINKXDataset._process_facebook semantics)."""
    from scipy.io import loadmat
    mat = loadmat(path)
    A = mat["A"].tocsr().tocoo()
    ei = np.stack([A.row.astype(np.int32), A.col.astype(np.int32)])
    meta = mat["local_info"].astype(np.int64)
    y = (meta[:, 1] - 1).astype(np.int32)  # gender - 1; -1 = unlabeled
    cols = np.concatenate([meta[:, :1], meta[:, 2:]], axis=1)
    xs = []
    for i in range(cols.shape[1]):
        _, inv = np.unique(cols[:, i], return_inverse=True)
        one_hot = np.zeros((cols.shape[0], inv.max() + 1), np.float32)
        one_hot[np.arange(cols.shape[0]), inv] = 1.0
        xs.append(one_hot)
    x = np.concatenate(xs, axis=1)
    return x, ei, y, {}


def load_geom_gcn(dirpath: str, sparse_features: bool = False):
    """geom-gcn raw text pair → arrays (Dataset.ipynb get_heterophily /
    HeterophilousDataset.ipynb WebKB/WikipediaNetwork/Actor.process).

    ``sparse_features=True`` is the film/Actor convention: the feature column
    holds keyword INDICES into a 932-dim binary vector rather than dense
    values.
    """
    edge_file = os.path.join(dirpath, "out1_graph_edges.txt")
    node_file = os.path.join(dirpath, "out1_node_feature_label.txt")
    with open(edge_file) as f:
        rows = [ln.split("\t") for ln in f.read().strip().split("\n")[1:]]
    ei = np.array([[int(a), int(b)] for a, b in rows], np.int32).T
    with open(node_file) as f:
        rows = [ln.split("\t") for ln in f.read().strip().split("\n")[1:]]
    n = len(rows)
    y = np.zeros(n, np.int32)
    feats = [None] * n
    for node_id, feat, label in rows:
        i = int(node_id)
        y[i] = int(label)
        feats[i] = list(map(int, feat.split(",")))
    if sparse_features:
        dim = max(max(f) for f in feats if f) + 1
        dim = max(dim, 932)  # Actor's documented keyword-vocabulary size
        x = np.zeros((n, dim), np.float32)
        for i, f in enumerate(feats):
            x[i, f] = 1.0
    else:
        x = np.array(feats, np.float32)
    return x, ei, y, {}


def load_film_linkx(dirpath: str):
    """LINKX film directory → arrays (Dataset.ipynb get_film)."""
    with open(os.path.join(dirpath, "class_map.json")) as f:
        class_map = {int(k): int(v) for k, v in json.load(f).items()}
    y = np.array([class_map[i] for i in sorted(class_map)], np.int32)
    x = np.load(os.path.join(dirpath, "feats.npy")).astype(np.float32)
    edges = np.genfromtxt(os.path.join(dirpath, "film_edges.csv"),
                          delimiter=",", skip_header=1, dtype=np.int64)
    ei = edges.T.astype(np.int32)
    return x, ei, y, {}


def load_linkx_tensors(dirpath: str):
    """LINKX cached-tensor directory → arrays (Dataset.ipynb cell 7
    ``LINKXpyg2``: torch.load of x.pt / edge_index.pt / y.pt, then a
    0.6/0.2/0.2 train_val_test_mask split)."""
    import torch
    from .transforms import train_val_test_masks

    def ld(fname):
        t = torch.load(os.path.join(dirpath, fname), map_location="cpu",
                       weights_only=True)
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    x = ld("x.pt").astype(np.float32)
    ei = ld("edge_index.pt").astype(np.int32)
    y = ld("y.pt").reshape(-1)
    # LINKX labels may be -1 (unlabeled) or years (arxiv-year pre-binning);
    # normalize negatives to a shifted contiguous range like the reference's
    # label-shape normalization (Dataset.ipynb get_data tail)
    y = y.astype(np.int64)
    if y.min() < 0:
        y = y - y.min()
    y = y.astype(np.int32)
    tr, va, te = train_val_test_masks(x.shape[0], 0.6, 0.2, 0.2)
    return x, ei, y, {"train_mask": tr, "val_mask": va, "test_mask": te}


def load_tensor_dir(dirpath: str):
    """Generic cached-tensor directory → arrays, with OFFICIAL masks.

    The convention for datasets the reference assembles in notebooks from
    heterogeneous sources — e.g. OGB_MAG (Dataset.ipynb ``elif DATASET_NAME
    == "OGB_MAG"``: paper.x with metapath2vec features, the
    paper-cites-paper edge_index, and the paper split masks wrapped in
    ``OGB_MAGcustom``): torch-save the homogeneous tensors as
    ``<data_dir>/<name>/{x.pt, edge_index.pt, y.pt}`` plus optional
    ``{train,val,test}_mask.pt``.  When masks are absent the registry
    generates the reference's default split.
    """
    import torch

    def ld(fname):
        t = torch.load(os.path.join(dirpath, fname), map_location="cpu",
                       weights_only=True)
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    x = ld("x.pt").astype(np.float32)
    ei = ld("edge_index.pt").astype(np.int32)
    y = ld("y.pt").reshape(-1).astype(np.int64)
    if y.min() < 0:
        y = y - y.min()
    masks = {}
    for mk in ("train_mask", "val_mask", "test_mask"):
        p = os.path.join(dirpath, f"{mk}.pt")
        if os.path.exists(p):
            masks[mk] = ld(f"{mk}.pt").astype(bool)
    return x, ei, y.astype(np.int32), masks


def load_graphsaint_dir(dirpath: str):
    """GraphSAINT raw directory → arrays (RedditTwo.ipynb Reddit2.process:
    CSR adjacency + feats + class_map + role split)."""
    import scipy.sparse as sp
    f = np.load(os.path.join(dirpath, "adj_full.npz"))
    adj = sp.csr_matrix((f["data"], f["indices"], f["indptr"]),
                        shape=tuple(f["shape"])).tocoo()
    ei = np.stack([adj.row.astype(np.int32), adj.col.astype(np.int32)])
    x = np.load(os.path.join(dirpath, "feats.npy")).astype(np.float32)
    n = x.shape[0]
    y = np.full(n, -1, np.int64)
    with open(os.path.join(dirpath, "class_map.json")) as fh:
        for k, v in json.load(fh).items():
            y[int(k)] = int(v)
    if y.min() < 0:
        y = y - y.min()
    with open(os.path.join(dirpath, "role.json")) as fh:
        role = json.load(fh)
    masks = {}
    for key, mk in (("tr", "train_mask"), ("va", "val_mask"),
                    ("te", "test_mask")):
        m = np.zeros(n, bool)
        m[np.asarray(role[key], np.int64)] = True
        masks[mk] = m
    return x, ei, y.astype(np.int32), masks


# datasets whose geom-gcn feature column is keyword indices, not dense values
GEOM_GCN_SPARSE = {"film", "actor"}


def try_load_vendored(data_dir: str, name: str):
    """Resolve ``name`` against the vendored on-disk conventions, or None.

    Checked in order:
      <data_dir>/<name>.mat                       (Facebook100)
      <data_dir>/<name>/raw/<name>.mat            (PyG-style raw dir)
      <data_dir>/<name>/out1_graph_edges.txt      (geom-gcn text)
      <data_dir>/<name>/raw/out1_graph_edges.txt
      <data_dir>/LINKXdataset/<name>/x.pt         (LINKX cached tensors)
      <data_dir>/<name>/x.pt                      (generic tensor dir with
                                                  official masks: OGB_MAG)
      <data_dir>/<name>/raw/adj_full.npz          (GraphSAINT/Reddit2)
      <data_dir>/<name>/adj_full.npz
      <data_dir>/<name>/class_map.json + feats.npy + film_edges.csv
                                                  (LINKX film)
    """
    lname = name.lower()
    for mat in (os.path.join(data_dir, f"{name}.mat"),
                os.path.join(data_dir, name, "raw", f"{lname}.mat")):
        if os.path.exists(mat):
            return load_fb100_mat(mat)
    for d in (os.path.join(data_dir, name),
              os.path.join(data_dir, name, "raw")):
        if os.path.exists(os.path.join(d, "out1_graph_edges.txt")):
            return load_geom_gcn(d, sparse_features=lname in GEOM_GCN_SPARSE)
    lx = os.path.join(data_dir, "LINKXdataset", name)
    if os.path.exists(os.path.join(lx, "x.pt")):
        return load_linkx_tensors(lx)
    td = os.path.join(data_dir, name)
    if os.path.exists(os.path.join(td, "x.pt")):
        return load_tensor_dir(td)
    for d in (os.path.join(data_dir, name, "raw"),
              os.path.join(data_dir, name)):
        if os.path.exists(os.path.join(d, "adj_full.npz")):
            return load_graphsaint_dir(d)
    d = os.path.join(data_dir, name)
    if os.path.exists(os.path.join(d, "class_map.json")):
        return load_film_linkx(d)
    return None

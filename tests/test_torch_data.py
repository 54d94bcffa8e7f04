"""The port's data layer (``sgs_gnn_tpu_torch/data``) against the JAX
package's, on the CPU.

Both packages' ``get_dataset`` get the same ``Config`` fields and the same
on-disk caches (written to ``tmp_path`` in every format the registry
reads) and must give identical arrays: x, edge_index, y, the masks,
num_classes and He exactly, the prior within 1e-7. Partitioning
(``partition_nodes`` rcm / native / random, ``shape_class_targets``,
``induced_subgraphs`` with and without the tile index, 1 and 3 shape
classes) must give identical batches.
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from sgs_gnn_tpu.core import Config as JConfig
from sgs_gnn_tpu.data import partition as jpart
from sgs_gnn_tpu.data import priors as jpriors
from sgs_gnn_tpu.data import registry as jreg
from sgs_gnn_tpu.data import synthetic as jsyn

from sgs_gnn_tpu_torch.core import Config
from sgs_gnn_tpu_torch.data import partition as tpart
from sgs_gnn_tpu_torch.data import priors as tpriors
from sgs_gnn_tpu_torch.data import registry as treg
from sgs_gnn_tpu_torch.data import synthetic as tsyn
from sgs_gnn_tpu_torch.data import transforms as ttr
from sgs_gnn_tpu_torch.data.native_partitioner import (cut_edges,
                                                       library_path)

FIELDS = ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask")


def _same_dataset(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert a.num_classes == b.num_classes and a.He == b.He
    assert a.name == b.name
    np.testing.assert_allclose(a.prob, b.prob, rtol=0, atol=1e-7)


def _both(name, data_dir="./Dataset", **kw):
    jds = jreg.get_dataset(JConfig(data_dir=str(data_dir), **kw), name)
    tds = treg.get_dataset(Config(data_dir=str(data_dir), **kw), name)
    return jds, tds


@pytest.mark.parametrize("name,kw", [
    ("Karate", {}), ("Moon", {}), ("SyntheticSBM", {}),
    ("SyntheticSBMLow", {}), ("SyntheticSBM", dict(syn=True, hn=0.3)),
    ("Karate", dict(syn=True, degree=6, hn=0.5)),
])
def test_fixtures_match_jax(tmp_path, name, kw):
    _same_dataset(*_both(name, tmp_path, **kw))


def test_community_generators_match_jax():
    kw = dict(n=1200, num_classes=7, communities=6, deg=12, feat_dim=16,
              seed=3)
    for fn in ("community_sbm_graph", "community_sbm_low_graph"):
        kw_ = dict(kw, num_classes=5) if fn.endswith("low_graph") else kw
        a = getattr(jsyn, fn)(**kw_)
        b = getattr(tsyn, fn)(**kw_)
        for u, v in zip(a[:3] + a[3], b[:3] + b[3]):
            np.testing.assert_array_equal(u, v, err_msg=fn)


# ------------------------------------------------ on-disk caches, every format


def _write_npz(d, rng):
    x, ei, y, (tr, va, te) = jsyn.sbm_graph(n=60, num_classes=3, deg=5,
                                            seed=2)
    np.savez(d / "Tolokers.npz", x=x, edge_index=ei, y=y, train_mask=tr,
             val_mask=va, test_mask=te)
    return "Tolokers"


def _write_npz_edge_attr(d, rng):
    ei = rng.integers(0, 10, (2, 40)).astype(np.int32)
    np.savez(d / "ogbn-proteins.npz", edge_index=ei,
             edge_attr=rng.random((40, 3)).astype(np.float32),
             y=rng.integers(0, 2, 10).astype(np.int32))
    return "ogbn-proteins"


def _write_heterophilous(d, rng):
    n, s = 50, 10
    masks = np.zeros((3, s, n), bool)
    for si in range(s):
        perm = rng.permutation(n)
        masks[0, si, perm[:25]] = masks[1, si, perm[25:37]] = True
        masks[2, si, perm[37:]] = True
    np.savez(d / "Roman-empire.npz",
             node_features=rng.normal(size=(n, 6)).astype(np.float32),
             node_labels=rng.integers(0, 4, n).astype(np.int64),
             edges=rng.integers(0, n, (200, 2)).astype(np.int64),
             train_masks=masks[0], val_masks=masks[1], test_masks=masks[2])
    return "Roman-empire"


def _write_planetoid(d, rng):
    raw = d / "SmallCora" / "raw"
    raw.mkdir(parents=True)
    n_allx, n_te, f, c = 30, 10, 4, 3
    n = n_allx + n_te
    allx = sp.csr_matrix(rng.random((n_allx, f)).astype(np.float32))
    ally = np.eye(c, dtype=np.int32)[rng.integers(0, c, n_allx)]
    blobs = {"x": allx[:6], "tx": sp.csr_matrix(rng.random((n_te, f))),
             "allx": allx, "y": ally[:6], "ally": ally,
             "ty": np.eye(c, dtype=np.int32)[rng.integers(0, c, n_te)],
             "graph": {i: [(i + 1) % n, (i + 7) % n] for i in range(n)}}
    for suffix, obj in blobs.items():
        with open(raw / f"ind.cora.{suffix}", "wb") as fh:
            pickle.dump(obj, fh)
    (raw / "ind.cora.test.index").write_text(
        "\n".join(str(i) for i in rng.permutation(np.arange(n_allx, n))))
    return "SmallCora"


def _write_linkx(d, rng):
    lx = d / "LINKXdataset" / "pokec"
    lx.mkdir(parents=True)
    torch.save(torch.tensor(rng.random((40, 5)).astype(np.float32)),
               lx / "x.pt")
    torch.save(torch.tensor(rng.integers(0, 40, (2, 120))), lx /
               "edge_index.pt")
    torch.save(torch.tensor(rng.integers(-1, 3, 40)), lx / "y.pt")
    return "pokec"


def _write_tensor_dir(d, rng):
    td = d / "OGB_MAG"
    td.mkdir()
    n = 30
    tr = np.zeros(n, bool)
    tr[:15] = True
    torch.save(torch.tensor(rng.random((n, 4)).astype(np.float32)),
               td / "x.pt")
    torch.save(torch.tensor(rng.integers(0, n, (2, 90))),
               td / "edge_index.pt")
    torch.save(torch.tensor(rng.integers(0, 5, n)), td / "y.pt")
    for k, m in (("train", tr), ("val", ~tr), ("test", ~tr)):
        torch.save(torch.tensor(m), td / f"{k}_mask.pt")
    return "OGB_MAG"


def _write_fb100(d, rng):
    n = 20
    a = sp.random(n, n, density=0.2, random_state=1, dtype=np.float64)
    a = ((a + a.T) > 0).astype(np.float64)
    meta = np.column_stack([
        rng.integers(1, 3, n), rng.integers(0, 3, n), rng.integers(1, 4, n),
        rng.integers(0, 2, n), rng.integers(1, 5, n),
        rng.integers(2005, 2008, n), np.full(n, 7)]).astype(np.float64)
    scipy.io.savemat(d / "reed98.mat", {"A": sp.csr_matrix(a),
                                        "local_info": meta})
    return "reed98"          # also the SVD feature augmentation


def _write_geom_gcn(d, rng):
    n = 12
    for name, feat in (("texas", lambda i: f"{i},0,2"),
                       ("film", lambda i: f"{i},{i + 2}")):
        g = d / name
        g.mkdir()
        (g / "out1_graph_edges.txt").write_text(
            "src\tdst\n" + "".join(f"{i}\t{(i + 1) % n}\n"
                                   for i in range(n)))
        (g / "out1_node_feature_label.txt").write_text(
            "id\tfeat\tlabel\n" + "".join(f"{i}\t{feat(i)}\t{i % 3}\n"
                                          for i in range(n)))
    return ("texas", "film")


def _write_graphsaint(d, rng):
    n = 30
    adj = sp.random(n, n, density=0.2, format="csr", random_state=3,
                    dtype=np.float64)
    raw = d / "Reddit2" / "raw"
    raw.mkdir(parents=True)
    np.savez(raw / "adj_full.npz", data=adj.data, indices=adj.indices,
             indptr=adj.indptr, shape=np.array(adj.shape))
    np.save(raw / "feats.npy", rng.random((n, 5)).astype(np.float32))
    (raw / "class_map.json").write_text(json.dumps(
        {str(i): int(v) for i, v in enumerate(rng.integers(0, 4, n))}))
    perm = rng.permutation(n).tolist()
    (raw / "role.json").write_text(json.dumps(
        {"tr": perm[:20], "va": perm[20:25], "te": perm[25:]}))
    return "Reddit2"


def _write_film_linkx(d, rng):
    f = d / "actor"
    f.mkdir()
    n = 15
    (f / "class_map.json").write_text(json.dumps(
        {str(i): int(i % 4) for i in range(n)}))
    np.save(f / "feats.npy", rng.random((n, 6)).astype(np.float32))
    (f / "film_edges.csv").write_text(
        "src,dst\n" + "".join(f"{i},{(i * 3 + 1) % n}\n" for i in range(n)))
    return "actor"


WRITERS = [_write_npz, _write_npz_edge_attr, _write_heterophilous,
           _write_planetoid, _write_linkx, _write_tensor_dir, _write_fb100,
           _write_geom_gcn, _write_graphsaint, _write_film_linkx]


@pytest.mark.parametrize("writer", WRITERS, ids=lambda w: w.__name__[7:])
def test_cached_formats_match_jax(tmp_path, writer):
    names = writer(tmp_path, np.random.default_rng(7))
    for name in names if isinstance(names, tuple) else (names,):
        _same_dataset(*_both(name, tmp_path))
    if writer is _write_npz:
        for cls in (JConfig, Config):
            cls(dataset="Tolokers", data_dir=str(tmp_path)).validate()


def test_reddit_subsample_and_missing_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    np.savez(tmp_path / "Reddit.npz",
             x=rng.random((80, 6)).astype(np.float32),
             edge_index=rng.integers(0, 80, (2, 1200)).astype(np.int32),
             y=rng.integers(0, 4, 80).astype(np.int32))
    _same_dataset(*_both("Reddit0.5", tmp_path))
    msgs = []
    for get, cls in ((jreg.get_dataset, JConfig),
                     (treg.get_dataset, Config)):
        with pytest.raises(FileNotFoundError, match="no network") as exc:
            get(cls(data_dir=str(tmp_path / "none")), "Cora")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_er_prior_matches_jax(tmp_path):
    x, ei, y, _ = jsyn.sbm_graph(n=80, num_classes=2, deg=6, seed=1)
    ei = ttr.to_undirected(ei)
    for thr in (2000, 0):        # exact pseudo-inverse; random walks
        a = jpriors.er_prior(ei[0], ei[1], 80, exact_threshold=thr)
        b = tpriors.er_prior(ei[0], ei[1], 80, exact_threshold=thr)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    b = tpriors.er_prior(ei[0], ei[1], 80, cache_dir=str(tmp_path),
                         dataset_name="g")
    assert (tmp_path / "g_erweight.npy").exists()
    a = jpriors.er_prior(ei[0], ei[1], 80, cache_dir=str(tmp_path),
                         dataset_name="g")       # reads the port's cache
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    jds, tds = _both("Karate", tmp_path, ER=True)
    _same_dataset(jds, tds)


# ----------------------------------------------------------- partitioning


def _sbm(n=300, deg=40, seed=9):
    x, ei, y, (tr, va, te) = jsyn.sbm_graph(n=n, num_classes=4, deg=deg,
                                            h=0.8, feat_dim=8, seed=seed)
    return x, ttr.to_undirected(ei), y, tr, va, te


@pytest.mark.parametrize("method", ["rcm", "native", "random"])
def test_partition_nodes_match_jax(method):
    x, ei, y, *_ = _sbm(n=500, deg=8)
    for k in (1, 3, 6):
        a = jpart.partition_nodes(ei, 500, k, method=method)
        b = tpart.partition_nodes(ei, 500, k, method=method)
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.int32
    assert tpart.resolve_partitioner(method) == method


def test_native_library_is_built_outside_native_dir():
    x, ei, y, *_ = _sbm(n=400, deg=8)
    part = tpart.partition_nodes(ei, 400, 4, method="native")
    path = library_path()
    assert path.exists() and path.parent.name == "native" \
        and path.parent.parent.name == "build"
    assert cut_edges(ei, part) < 0.6 * cut_edges(
        ei, np.random.default_rng(0).integers(0, 4, 400).astype(np.int32))


def test_shape_class_targets_match_jax():
    rng = np.random.default_rng(4)
    for m in (1, 2, 5, 9):
        counts = rng.integers(1, 1000, m).tolist()
        for k in (1, 2, 3, 16):
            assert tpart.shape_class_targets(counts, k) == \
                jpart.shape_class_targets(counts, k)


GRAPH_FIELDS = ("x", "senders", "receivers", "y", "train_mask", "val_mask",
                "test_mask", "prob", "edge_mask", "edge_aux", "tile_ls",
                "tile_lr", "tile_su", "tile_rv", "tile_perm", "tile_prob",
                "tile_mask", "tile_aux")


def _same_batches(jb, tb):
    assert len(jb) == len(tb)
    for i, (a, b) in enumerate(zip(jb, tb)):
        for f in GRAPH_FIELDS:
            va_, vb = getattr(a, f), getattr(b, f)
            assert (va_ is None) == (vb is None), f
            if va_ is not None:
                np.testing.assert_array_equal(np.asarray(va_), vb.numpy(),
                                              err_msg=f"batch {i} {f}")
                assert np.asarray(va_).dtype == vb.numpy().dtype, f
        for f in ("receiver_band", "tile_t", "tile_b", "num_classes"):
            assert getattr(a, f) == getattr(b, f), f


# SyntheticReddit's recipe cut to 3,000 nodes in 6 communities (386,770
# edges): at a metis_threshold of 8,000 edges the native partitioner is
# asked for 49 parts and fills 45 of them (at most 78 nodes and one
# 128-row tile each; every part keeps the tile layout)
MANY_PARTS = dict(n=3000, communities=6, deg=80, seed=0)
MANY_PARTS_THRESHOLD = 8000


def _many_parts_graph():
    x, ei, y, (tr, va, te) = jsyn.community_sbm_graph(**MANY_PARTS)
    return x, ttr.to_undirected(ei), y, tr, va, te


def _compacted_native_parts(ei, n, k):
    """The native partition into ``k`` parts with the unused ones dropped,
    as both drivers compact it (``prepare_batches``)."""
    part = jpart.partition_nodes(ei, n, k, method="native")
    used = np.unique(part)
    assert used.size < k      # the case: some parts left unused
    remap = np.full(k, -1, np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    return remap[part], int(used.size)


@pytest.mark.parametrize("parts,classes,tiles", [
    pytest.param(3, 1, False, id="1-False"),
    pytest.param(3, 1, True, id="1-True"),
    pytest.param(3, 3, False, id="3-False"),
    pytest.param(3, 3, True, id="3-True"),
    pytest.param("many", 3, False, id="many_parts-3-False"),
    pytest.param("many", 3, True, id="many_parts-3-True"),
])
def test_induced_subgraphs_match_jax(parts, classes, tiles):
    if parts == "many":
        # 45 used parts of 49 asked for, 3 shape classes: the
        # per-part edge grouping (``part_edge_ids``) at many parts
        x, ei, y, tr, va, te = _many_parts_graph()
        k = int(np.ceil(ei.shape[1] / MANY_PARTS_THRESHOLD))
        part, parts = _compacted_native_parts(ei, len(y), k)
        assert parts >= 40
    else:
        # ~100 nodes per part: one 128-row tile, dense enough that the
        # tile layout is kept, with slot counts that differ per part
        x, ei, y, tr, va, te = _sbm()
        part = jpart.partition_nodes(ei, 300, 3, method="native")
    jb = jpart.induced_subgraphs(x, ei, y, tr, va, te, part, parts,
                                 tile_index=tiles, shape_classes=classes)
    tb = tpart.induced_subgraphs(x, ei, y, tr, va, te, part, parts,
                                 tile_index=tiles, shape_classes=classes,
                                 device="cpu")
    assert len({g.num_edges for g in tb}) == min(classes, 3)
    if tiles:
        assert all(g.tile_t == 128 for g in tb)
        # one slot count per shape class (at many parts two classes may
        # round up to the same count)
        slots = {(g.num_edges, g.tile_ls.shape[0]) for g in tb}
        assert len(slots) == len({g.num_edges for g in tb})
        if parts == 3:
            assert len({g.tile_ls.shape[0] for g in tb}) == len(
                {g.num_edges for g in tb})
    _same_batches(jb, tb)


def test_part_edge_ids_match_the_loop():
    # the loop it replaces, one pass over every edge per part, with parts
    # left empty, ids at or past num_parts ignored and a 17-bit key
    rng = np.random.default_rng(5)
    for num_parts, top in ((7, 7), (40, 47), (70_000, 70_000)):
        ps = rng.integers(0, top, 5000).astype(np.int32)
        pr = np.where(rng.random(5000) < 0.7, ps,
                      rng.integers(0, top, 5000)).astype(np.int32)
        got = tpart.part_edge_ids(ps, pr, num_parts)
        assert len(got) == num_parts
        for p in range(num_parts):
            want = np.where((ps == pr) & (ps == p))[0]
            np.testing.assert_array_equal(got[p], want)
            assert got[p].dtype == want.dtype


def _multigraph(seed):
    """A directed multigraph with repeated edges, both directions of some,
    self-loops and a few edges on isolated ids far above the rest."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 60, 900)
    r = rng.integers(0, 60, 900)
    dup = rng.integers(0, 900, 300)
    s = np.concatenate([s, s[dup], r[:50], np.arange(10), [5000, 77, 4999]])
    r = np.concatenate([r, r[dup], s[:50], np.arange(10), [77, 5000, 4999]])
    return np.stack([s, r]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_to_undirected_matches_jax(seed):
    from sgs_gnn_tpu.data import transforms as jtr
    ei = _multigraph(seed)
    for edges in (ei, ei.astype(np.int64), ei[:, ::-1], ei[:, :0]):
        want = jtr.to_undirected(edges)
        got = ttr.to_undirected(edges)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape
    assert ttr.is_undirected(ttr.to_undirected(ei), 5001)


def test_prepare_batches_many_parts_match_jax():
    """Both drivers' ``prepare_batches`` on the many-part graph: 49 parts
    asked for, 45 used (compacted), 3 shape classes, the tile index."""
    from sgs_gnn_tpu.run import driver as jdriver
    from sgs_gnn_tpu_torch.run import driver as tdriver
    x, ei, y, tr, va, te = _many_parts_graph()
    kw = dict(mode="learned", pipeline="hybrid", tile_index="on",
              metis_threshold=MANY_PARTS_THRESHOLD, shape_classes=3)
    prob = jpriors.degree_prior(ei[0], ei[1], len(y))
    common = dict(name="SyntheticReddit4000", x=x, edge_index=ei, y=y,
                  train_mask=tr, val_mask=va, test_mask=te,
                  num_classes=int(y.max()) + 1, He=0.0)
    jb, jq = jdriver.prepare_batches(
        JConfig(**kw), jreg.HostDataset(prob=prob, **common))
    tb, tq, method = tdriver.prepare_batches(
        Config(**kw), treg.HostDataset(prob=prob, **common), "cpu")
    assert method == "native" and tq == jq == 1600
    assert len(tb) >= 40
    assert len({g.num_edges for g in tb}) == 3
    assert all(g.tile_t == 128 for g in tb)
    _same_batches(jb, tb)


def test_unify_tile_shapes_declined_part_drops_tiles():
    x, ei, y, tr, va, te = _sbm()
    part = jpart.partition_nodes(ei, 300, 3, method="native")
    tb = tpart.induced_subgraphs(x, ei, y, tr, va, te, part, 3,
                                 tile_index=True, shape_classes=1,
                                 device="cpu")
    assert all(g.tile_t == 128 for g in tb)
    declined = tpart.unify_tile_shapes(
        [tb[0], dataclasses.replace(tb[1], **tpart._NO_TILES)])
    assert all(g.tile_t == 0 and g.tile_ls is None for g in declined)

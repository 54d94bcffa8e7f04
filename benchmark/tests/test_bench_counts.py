"""The frozen operation and byte counts against values worked by hand at
small shapes."""
import pytest

from benchmark import counts

GCN = dict(GNN="GCN", edge_mlp_type="GCN", num_features=3, nhid=2,
           num_classes=2, gat_heads=1)


def test_dense_and_gcn_layer():
    # 2 * n * fin * fout = 2 * 4 * 3 * 2 = 48; backward doubles with the
    # input's gradient
    assert counts.dense(4, 3, 2, False) == (48, 48)
    assert counts.dense(4, 3, 2, True) == (48, 96)
    # + 2 * e * fout = 2 * 5 * 2 = 20 both ways
    assert counts.gcn_layer(4, 5, 3, 2, False) == (68, 68)


def test_head_counts_its_two_layers_and_twice_for_the_backward():
    # per edge: 2 * (2k) * k + 2 * k = 2 * 4 * 2 + 4 = 20
    assert counts.head(3, 2) == (60, 120)


def test_sage_and_gat_layers():
    # mean of e rows of fin: 2 * 5 * 3 = 30; two projections 2 * 48
    assert counts.sage_layer(4, 5, 3, 2) == (30 + 96, 96)
    # projection 48; attention 2 * 2 * n * hf = 32; rows 2 * (e + n) * hf
    # = 36; backward 48 (weights only) + 32 + 72
    assert counts.gat_layer(4, 5, 3, 2, False) == (48 + 32 + 36,
                                                  48 + 32 + 72)


def test_train_step_learned_and_random():
    n, e, q = 4, 7, 5
    enc = sum(counts.gcn_layer(n, q, 3, 2, False)) \
        + sum(counts.gcn_layer(n, q, 2, 2, True))
    bb = sum(counts.gcn_layer(n, q, 3, 2, False)) \
        + sum(counts.gcn_layer(n, q, 2, 2, True))
    want = enc + counts.head(e, 2)[0] + sum(counts.head(q, 2)) + 2 * bb
    assert counts.train_step_flops(GCN, "learned", n, e, q) == want
    assert counts.train_step_flops(GCN, "random", n, e, q) == bb


def test_eval_counts_the_scorer_only_in_learned_mode():
    n, e, q = 4, 7, 5
    fwd = counts.gcn_layer(n, q, 3, 2, False)[0] \
        + counts.gcn_layer(n, q, 2, 2, True)[0]
    enc = counts.gcn_layer(n, e, 3, 2, False)[0] \
        + counts.gcn_layer(n, e, 2, 2, True)[0]
    assert counts.eval_flops(GCN, "random", n, e, q, 3) == 3 * fwd
    assert counts.eval_flops(GCN, "learned", n, e, q, 1) == \
        fwd + enc + counts.head(e, 2)[0]


def test_row_kernel_bytes():
    # K1: e * f * elem + 4 e + 4 n f = 5*2*2 + 20 + 4*4*2 = 72
    assert counts.k1_bytes(5, 2, 2, 4) == 72
    # K2: 8 e + 4 n = 40 + 16
    assert counts.k2_bytes(5, 4) == 56
    # one two-layer GCN forward, widths (2, 2): two K1, two K2
    assert counts.gcn_rows(4, 5, (2, 2), False) == 2 * 72 + 2 * 56
    assert counts.gcn_rows(4, 5, (2, 2), True) == 4 * 72 + 2 * 56


def test_rows_of_a_learned_step_and_an_eval():
    n, e, q = 4, 7, 5
    want = (counts.gcn_rows(n, q, (2, 2), True)
            + 2 * counts.gcn_rows(n, q, (2, 2), True)
            + 2 * counts.k1_bytes(q, 2, 4, n))
    assert counts.rows_train_bytes(GCN, "learned", n, e, q) == want
    assert counts.rows_eval_bytes(GCN, "learned", n, e, q, 1) == \
        counts.gcn_rows(n, q, (2, 2), False) \
        + counts.gcn_rows(n, e, (2, 2), False)


def test_rows_are_not_counted_for_gat():
    with pytest.raises(NotImplementedError):
        counts.rows_train_bytes(dict(GCN, GNN="GAT"), "learned", 4, 7, 5)

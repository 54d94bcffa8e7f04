"""The benchmark's frozen count of the work SGS-GNN needs, from the shapes
alone, and the H100's published peaks.

Operations count a multiply-add as two; the elementwise work (activations,
dropout, normalisation, the optimizer) is left out, and so is work the
program repeats (the score head's backward recomputes its forward) or
spends on padding (ghost nodes, padding edges, padding tile slots): a
count is what the inputs need. Bytes count each input byte read once and
each output byte written once.

Shapes: ``n`` real nodes of a partition, ``e`` its valid edges, ``q`` the
sampled edges, ``fin`` the features, ``k`` the hidden width, ``c`` the
classes, ``heads`` GAT's first-layer heads.
"""
from __future__ import annotations

from . import archs

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12

BF16, F32, ID = 2, 4, 4     # bytes of a bf16 and an f32 value, an int32 id


# ---------------------------------------------------------- operations

def dense(n, fin, fout, grad_in):
    """(forward, backward) of an (n, fin) x (fin, fout) projection; the
    backward forms the weight's gradient and, with ``grad_in``, the
    input's."""
    f = 2 * n * fin * fout
    return f, f * (2 if grad_in else 1)


def gcn_layer(n, e, fin, fout, grad_in):
    """GCN layer: the projection, then the sum of e scaled rows of width
    fout (its backward sums as many)."""
    df, db = dense(n, fin, fout, grad_in)
    return df + 2 * e * fout, db + 2 * e * fout


def sage_layer(n, e, fin, fout):
    """GraphSAGE layer on the raw features: the mean of e rows of width
    fin, then two projections; no gradient reaches the features."""
    df, db = dense(n, fin, fout, False)
    return 2 * e * fin + 2 * df, 2 * db


def gat_layer(n, e, fin, hf, grad_in):
    """GAT layer: the projection, the two attention terms per node, and
    the e + n attention-weighted rows of width hf (self-loops included);
    the backward sums rows for the projected table and for the weights."""
    df, db = dense(n, fin, hf, grad_in)
    att = 2 * 2 * n * hf
    msg = 2 * (e + n) * hf
    return df + att + msg, db + att + 2 * msg


def head(rows, k):
    """The score head over ``rows`` edges: fc1 on [h_u * h_v || h_u - h_v]
    (2k -> k), fc2 (k -> 1). Its backward forms dW1 and dh: twice."""
    f = rows * (2 * (2 * k) * k + 2 * k)
    return f, 2 * f


def _fb(pair, backward):
    return pair[0] + (pair[1] if backward else 0)


def backbone(cfg, n, e, backward):
    """The backbone on e edges, with its backward (its module under
    ``benchmark/archs/``)."""
    return _fb(archs.backbone(cfg).count(cfg, n, e), backward)


def scorer_encoder(cfg, n, e, backward):
    """The scorer's encoder on e edges, with its backward."""
    return _fb(archs.scorer(cfg).count(cfg, n, e), backward)


def train_step_flops(cfg, mode, n, e, q):
    """One sampled step. Learned (hybrid_rescore): the scorer's encoder on
    the random q-subgraph, the detached head over the e edges, the head on
    the q winners with its backward, the backbone on the winners and on
    the random subgraph, both with their backward. Random: the backbone on
    q edges with its backward."""
    if mode == "random":
        return backbone(cfg, n, q, True)
    return (scorer_encoder(cfg, n, q, True) + head(e, cfg["nhid"])[0]
            + sum(head(q, cfg["nhid"])) + 2 * backbone(cfg, n, q, True))


def eval_flops(cfg, mode, n, e, q, draws):
    """One partition's eval, or one served request: learned, the scorer
    over all e edges and ``draws`` backbone forwards on q edges; random,
    the draws alone."""
    f = draws * backbone(cfg, n, q, False)
    if mode == "learned":
        f += scorer_encoder(cfg, n, e, False) + head(e, cfg["nhid"])[0]
    return f


def head_train_flops(cfg, e, q):
    """The head kernels' work in one learned step: the e valid edges
    scored detached (K6), the q winners forward (K3) and backward (K5)."""
    k = cfg["nhid"]
    return head(e, k)[0] + sum(head(q, k))


def head_eval_flops(cfg, e):
    """K3 over the e valid edges of an eval or a served request."""
    return head(e, cfg["nhid"])[0]


# --------------------------------------------------------------- bytes

def k1_bytes(e, f, elem, n):
    """K1 (scatter_add): e rows of f values of ``elem`` bytes and e ids
    read, n x f float32 sums written."""
    return e * f * elem + e * ID + n * f * F32


def k2_bytes(e, n):
    """K2 (segment_sum_scalar): e float32 values and e ids read, n float32
    sums written."""
    return e * (F32 + ID) + n * F32


def gcn_rows(n, e, widths, backward):
    """K1 and K2 bytes of a two-layer GCN on e edges, bf16 rows of the
    given widths: per layer one K1 forward (one more backward, the
    gather's transpose) and one K2 for the degrees."""
    b = sum(k1_bytes(e, f, BF16, n) for f in widths)
    return b * (2 if backward else 1) + len(widths) * k2_bytes(e, n)


def rows_train_bytes(cfg, mode, n, e, q):
    """One sampled step of a GCN backbone with a GCN scorer (learned) or
    alone (random): the two GCN stacks of the learned step on q edges
    each (scorer k, k; backbone k, c; twice: learned and random), reg2's
    two row gathers of the f32 logits transposed; random mode one
    backbone."""
    k, c = cfg["nhid"], cfg["num_classes"]
    if cfg["GNN"] != "GCN" or (mode == "learned"
                               and cfg["edge_mlp_type"] != "GCN"):
        raise NotImplementedError("rows bytes: GCN configurations only")
    if mode == "random":
        return gcn_rows(n, q, (k, c), True)
    return (gcn_rows(n, q, (k, k), True) + 2 * gcn_rows(n, q, (k, c), True)
            + 2 * k1_bytes(q, c, F32, n))


def rows_eval_bytes(cfg, mode, n, e, q, draws):
    """One partition's eval: learned, the GCN scorer over the e edges and
    ``draws`` backbone forwards on q edges; random, the draws alone."""
    k, c = cfg["nhid"], cfg["num_classes"]
    b = draws * gcn_rows(n, q, (k, c), False)
    if mode == "learned":
        b += gcn_rows(n, e, (k, k), False)
    return b

"""GIN backbone: two GIN layers with eps = 0, relu and dropout between
them. A layer sums its input's rows over the incoming edges in float32,
z_i = x_i + sum_{j->i} x_j, then applies Linear-ReLU-Linear at the
configuration's rounding: GIN_conv1 602 -> nhid -> nhid, GIN_conv2 nhid ->
nhid -> classes. GIN takes no edge weight, as PyG's layer does: ``w`` is
not read.

Departures from the published layer (PyG's ``GINConv`` inside the
reference's GIN model): none in the arithmetic. eps is 0, PyG's default
and not trained; the inner MLP has no normalisation and no dropout, as
that model builds it. The projections round at the configuration's
precision, the sums do not.

Also the configuration's frozen row counts, from the shapes alone:

  * K1 bytes (``counts.k1_bytes``): each layer's sum one K1 over e float32
    rows of its input width; the second layer's, whose input takes a
    gradient, one more in the backward (its transpose over the senders);
    the first layer's input is the features, which take none;
  * message bytes: the (E, F) float32 message matrix each sum's gather
    writes in the forward, E x F x 4 for each sum.
"""
import torch

from benchmark import counts
from benchmark import reference as R


def _layer(m, name, x, s, r, n):
    z = x + R.index_sum(x[s.long()], r, n)
    h = torch.relu(R.linear(z, m.P[name + ".mlp_lin1.weight"],
                            m.P[name + ".mlp_lin1.bias"], m.pr))
    return R.linear(h, m.P[name + ".mlp_lin2.weight"],
                    m.P[name + ".mlp_lin2.bias"], m.pr)


def forward(m, x, s, r, w, n, gen):
    h = torch.relu(_layer(m, "GIN_conv1", x, s, r, n))
    if gen is not None:
        h = R.dropout(h, m.rate, gen)
    return _layer(m, "GIN_conv2", h, s, r, n)


def _layer_count(n, e, fin, hid, fout, grad_in):
    """The sum of e rows of width fin (an add a value; with ``grad_in``
    its transpose in the backward), then the two projections."""
    a = counts.dense(n, fin, hid, grad_in)
    b = counts.dense(n, hid, fout, True)
    return e * fin + a[0] + b[0], (e * fin if grad_in else 0) + a[1] + b[1]


def count(cfg, n, e):
    fin, k, c = cfg["num_features"], cfg["nhid"], cfg["num_classes"]
    a = _layer_count(n, e, fin, k, k, False)
    b = _layer_count(n, e, k, k, c, True)
    return a[0] + b[0], a[1] + b[1]


# ---------------------------------------------------------------- rows

def k1_backbone(cfg, n, e, backward):
    """K1 bytes of one backbone pass on e edges, with its backward."""
    fin, k = cfg["num_features"], cfg["nhid"]
    b = counts.k1_bytes(e, fin, counts.F32, n) \
        + counts.k1_bytes(e, k, counts.F32, n)
    return b + (counts.k1_bytes(e, k, counts.F32, n) if backward else 0)


def k1_step_bytes(cfg, n, e, q, case):
    """K1 bytes of one trained step: ``case`` 2, a learned step, the
    backbone on the q winners and on the random q-subgraph, each with its
    backward, and reg2's two gathers of the float32 logits transposed;
    ``case`` 1, the backbone on the partition's e edges with its
    backward."""
    if case == 1:
        return k1_backbone(cfg, n, e, True)
    return (2 * k1_backbone(cfg, n, q, True)
            + 2 * counts.k1_bytes(q, cfg["num_classes"], counts.F32, n))


def k1_eval_bytes(cfg, n, e, q, draws, whole):
    """K1 bytes of one partition's eval or one served request: ``draws``
    backbone forwards on q edges (the MLP scorer sums nothing); with
    ``whole`` (a partition of q or fewer valid edges), one forward on its
    e edges."""
    if whole:
        return k1_backbone(cfg, n, e, False)
    return draws * k1_backbone(cfg, n, q, False)


def message_bytes(cfg, e):
    """The float32 message matrices of one backbone forward on e edges."""
    return e * (cfg["num_features"] + cfg["nhid"]) * counts.F32


def message_step_bytes(cfg, e, q, case):
    """Message bytes of one trained step: ``case`` 2, the backbone's two
    forwards on q edges; ``case`` 1, one forward on the batch's e edges
    (padding included: the program sums every edge of the batch)."""
    return message_bytes(cfg, e) if case == 1 else 2 * message_bytes(cfg, q)


def message_eval_bytes(cfg, e, q, draws, whole):
    """Message bytes of one eval or served request: ``draws`` forwards on
    q edges, or with ``whole`` one on the batch's e edges (padding
    included)."""
    return message_bytes(cfg, e) if whole else draws * message_bytes(cfg, q)

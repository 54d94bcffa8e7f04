"""GCNII backbone (Chen, Wei, Huang, Ding, Li: Simple and Deep Graph
Convolutional Networks, ICML 2020, Eq. 5) at the paper's PPI setting:
LAYERS = 9 layers of WIDTH = 2048 columns, ALPHA = 0.5, LAM = 1.0.

    h0 = relu(x W_in + b_in)                                 602 -> 2048
    h_l = relu(((1 - a) P h_{l-1} + a h0) ((1 - b_l) I + b_l W_l)),
          b_l = ln(LAM / l + 1), l = 1..LAYERS, W_l 2048 x 2048, no bias
    logits = h_LAYERS W_out + b_out                          2048 -> 41

P = D^-1/2 (A_w + I) D^-1/2 is GCN's normalisation as ``reference.gcn``
builds it: the scorer's probabilities ``w`` weight the drawn edges, D is
the weighted in-degree plus one, the self-loop term added apart. Dropout
at the configuration's rate before each layer (input, convolutions,
output) when ``gen`` is given, as the paper's model has it.

Rounding at ``m.pr`` where the program rounds: every projection's inputs,
weights and output; each layer's h before its propagation and the scaled
rows the propagation sums, as GCN rounds XW and its scaled rows. The
propagation's sums, the mix and the identity map are float32, the
products full float32 (TF32 off, as ``compare.check`` has it).

Departures from the paper:

  * weights random from the seed (no trained checkpoint is public);
  * Eq. 5 (GCNII), not Eq. 6 (GCNII*);
  * P holds the scorer's probabilities as edge weights, as SGS-GNN's GCN
    backbone takes them; the paper's graph is unweighted;
  * the rows a layer propagates are in the compute dtype (bf16);
  * dropout 0.3, the SGS Reddit run's, not the PPI run's 0.2 (serving runs
    none);
  * Reddit-shaped data and partitions in place of PPI, and single-label
    logits for the cross-entropy in place of PPI's multi-label outputs.

Also the frozen operation count (``count``) and the bytes one
propagation must move whatever route runs it (``prop_bytes``).
"""
import math

import torch

from benchmark import counts
from benchmark import reference as R

LAYERS, WIDTH, ALPHA, LAM = 9, 2048, 0.5, 1.0


def beta(layer):
    """The identity map's weight of layer ``layer`` (1-based)."""
    return math.log(LAM / layer + 1.0)


def propagate(h, s, r, w, n, pr):
    """P h in float32: h rounded, the rows scaled by D^-1/2 and rounded,
    summed over the edges (weighted by ``w``; None: unweighted), scaled
    again, the self-loop term added."""
    wd = (torch.ones(s.shape[0], device=h.device) if w is None
          else w.float())
    dis = torch.rsqrt(R.index_sum(wd, r, n) + 1.0)
    hr = pr(h)
    msg = pr(hr * dis[:, None])[s.long()]
    if w is not None:
        msg = msg * w[:, None]
    agg = R.index_sum(msg, r, n)
    return agg * dis[:, None] + (dis * dis)[:, None] * hr


def forward(m, x, s, r, w, n, gen):
    # full float32 products (compare.check sets the same before the check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = m.P

    def drop(h):
        return h if gen is None else R.dropout(h, m.rate, gen)
    h0 = torch.relu(R.linear(drop(x), P["GCNII_in.weight"],
                             P["GCNII_in.bias"], m.pr))
    h = h0
    for layer in range(1, LAYERS + 1):
        z = ((1.0 - ALPHA) * propagate(drop(h), s, r, w, n, m.pr)
             + ALPHA * h0)
        b = beta(layer)
        zw = R.linear(z, P[f"GCNII_conv{layer}.lin.weight"], None, m.pr)
        h = torch.relu((1.0 - b) * z + b * zw)
    return R.linear(drop(h), P["GCNII_out.weight"], P["GCNII_out.bias"],
                    m.pr)


def count(cfg, n, e):
    """(forward, backward) operations on e edges: the input projection (no
    gradient reaches the features); per layer the propagation (a
    multiply-add per edge and column; its transpose in the backward), the
    alpha-mix and the identity map's blend (a multiply-add per node and
    column each, forward and backward) and W_l's product (its input takes a
    gradient); the output projection."""
    fin, c = cfg["num_features"], cfg["num_classes"]
    fwd, bwd = counts.dense(n, fin, WIDTH, False)
    for _ in range(LAYERS):
        df, db = counts.dense(n, WIDTH, WIDTH, True)
        prop, blend = 2 * e * WIDTH, 2 * 2 * n * WIDTH
        fwd += prop + blend + df
        bwd += prop + blend + db
    of, ob = counts.dense(n, WIDTH, c, True)
    return fwd + of, bwd + ob


def prop_bytes(n, e, f):
    """Bytes one propagation of f bf16 columns over e edges and n nodes
    must move, on any route: each edge's two int32 ids and float32 weight
    read, the n x f rows read once and the n x f result written once."""
    return e * (2 * counts.ID + counts.F32) + 2 * n * f * counts.BF16

"""The plain reference of SGS-GNN: plain PyTorch, float32, no kernel, no
graph capture, nothing of the program imported.

It works out again everything the program derives from the benchmark's
inputs: the induced subgraph of each partition with its padding, receiver
sort, degree prior and tile-pair index (``build_batch``); the scorer, the
score head with its counter-hash dropout, the layers the backbones and
scorers are made of (GCN, GraphSAGE, GAT: each architecture composes
them in its module under ``benchmark/archs/``); the samplers; the
losses; and the dual Adam update with its gated edge group.

Random draws follow the program's stream: the same ``torch.Generator``
calls (``torch.rand`` of the same shapes, ``torch.randint`` for the score
head's dropout seed) in the same order, on the same device, from the same
seed, so the uniforms and the dropout masks are the program's. What the
reference does not recompute is a choice made by the program's rounding:
the training step's q winners (the Gumbel top-q of the program's own
probabilities, which rounding reorders at the margin and which the score
head's per-slot dropout is keyed to) and the conditional gate. The step
takes both from the program and ``winner_miss`` / ``gate_gap`` judge them
against the reference's own (``benchmark/compare.py``).

``Precision`` puts the rounding of the compute dtype where the program
computes in it (the inputs, weights and outputs of every dense
projection, the scaled rows a GCN layer aggregates, the scorer's
embeddings): ``float32`` rounds nothing; the control rounds to float8
(e4m3), the step below the configuration's bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import archs

TINY = torch.finfo(torch.float32).tiny
EPS_NORM = 1e-12
HEAD_BLOCK = 1 << 17       # edges per block of the score head


class Precision:
    """Rounds a tensor to ``dtype`` and back (straight through: the
    gradient passes unrounded); None rounds nothing."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, t):
        if self.dtype is None:
            return t
        r = t.detach().to(self.dtype).to(t.dtype)
        return t + (r - t.detach()) if t.requires_grad else r


F32 = Precision(None)
FP8 = Precision(torch.float8_e4m3fn)


# ---------------------------------------------------------------- batches

def tile_index(s, r, num_nodes, t=128, b=512, max_overhead=1.35):
    """Edges bucketed by (sender // t, receiver // t), each bucket padded
    to a multiple of b slots; None when that exceeds max_overhead * E."""
    s = np.asarray(s, np.int64)
    r = np.asarray(r, np.int64)
    e = s.shape[0]
    n_pad = (max(num_nodes, t) + t - 1) // t * t
    nt = n_pad // t
    pair = (s // t) * nt + (r // t)
    order = np.argsort(pair, kind="stable")
    uniq, counts = np.unique(pair[order], return_counts=True)
    padded = -(-counts // b) * b
    total = int(padded.sum())
    if total > max_overhead * e:
        return None
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    cstart = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.repeat(starts - cstart, counts) + np.arange(e)
    ls = np.zeros(total, np.int32)
    lr = np.zeros(total, np.int32)
    perm = np.zeros(total, np.int32)
    valid = np.zeros(total, bool)
    ls[slot] = s[order] % t
    lr[slot] = r[order] % t
    perm[slot] = order
    valid[slot] = True
    blocks = np.repeat(uniq, padded // b)
    return dict(ls=ls, lr=lr, su=(blocks // nt).astype(np.int32),
                rv=(blocks % nt).astype(np.int32), perm=perm, valid=valid,
                t=t, b=b)


def build_batch(inputs, part, p, max_n, pad_edges_to, tiles=True,
                tile_slots=None):
    """Partition p's batch as the driver builds it: the nodes of part p in
    ascending order, relabelled; the edges with both endpoints in p, in
    ascending edge order; the degree prior of those edges; padding to
    ``max_n`` nodes (the last a ghost) and ``pad_edges_to`` edges
    (self-loops on the ghost, invalid, zero prior); a stable sort by
    receiver; packed flags; with ``tiles`` the tile-pair index, padded to
    ``tile_slots`` slots with invalid blocks on tile (0, 0). Numpy arrays
    by the program's field names."""
    from .datagen import degree_prior
    x, ei, y, (tr, va, te) = inputs[:4]
    nodes = np.flatnonzero(part == p)
    relabel = np.full(len(part), -1, np.int64)
    relabel[nodes] = np.arange(len(nodes))
    inside = (part[ei[0]] == p) & (part[ei[1]] == p)
    s = relabel[ei[0][inside]].astype(np.int32)
    r = relabel[ei[1][inside]].astype(np.int32)
    n, e = len(nodes), len(s)
    prob = degree_prior(s, r, n)
    ghost = max_n - 1
    pad_n, pad_e = max_n - n, pad_edges_to - e

    def padded(a, k, fill=0):
        return np.concatenate([a, np.full((k,) + a.shape[1:], fill,
                                          a.dtype)])
    out = dict(x=padded(x[nodes], pad_n), y=padded(y[nodes], pad_n),
               train_mask=padded(tr[nodes], pad_n),
               val_mask=padded(va[nodes], pad_n),
               test_mask=padded(te[nodes], pad_n))
    s = padded(s, pad_e, ghost)
    r = padded(r, pad_e, ghost)
    prob = padded(prob, pad_e)
    emask = padded(np.ones(e, bool), pad_e, False)
    order = np.argsort(r, kind="stable")
    s, r, prob, emask = s[order], r[order], prob[order], emask[order]
    trm, yy = out["train_mask"], out["y"]
    flags = ((trm[s] & trm[r]).astype(np.int32)
             | ((yy[s] == yy[r]).astype(np.int32) << 1)
             | (emask.astype(np.int32) << 2))
    out.update(senders=s, receivers=r, prob=prob, edge_mask=emask,
               edge_aux=np.stack([s, r, flags], 1).astype(np.int32))
    if tiles:
        ti = tile_index(s, r, max_n)
        if ti is None:
            raise ValueError(f"part {p}: the tile layout exceeds 1.35 E")
        k = (tile_slots or len(ti["ls"])) - len(ti["ls"])
        tmask = ti["valid"] & emask[ti["perm"]]
        taux = out["edge_aux"][ti["perm"]]
        taux[:, 2] = (taux[:, 2] & 3) | (tmask.astype(np.int32) << 2)
        out.update(
            tile_ls=padded(ti["ls"], k), tile_lr=padded(ti["lr"], k),
            tile_su=padded(ti["su"], k // ti["b"]),
            tile_rv=padded(ti["rv"], k // ti["b"]),
            tile_perm=padded(ti["perm"], k),
            tile_prob=padded(np.where(ti["valid"], prob[ti["perm"]],
                                      0).astype(np.float32), k),
            tile_mask=padded(tmask, k), tile_aux=padded(taux, k),
            tile_t=ti["t"], tile_b=ti["b"])
    return out


def to_device(batch, device):
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


# ------------------------------------------------------------------ layers

def linear(x, w, b, pr):
    out = pr(x) @ pr(w).t()
    if b is not None:
        out = out + b
    return pr(out)


def index_sum(rows, idx, n):
    out = torch.zeros((n,) + rows.shape[1:], dtype=rows.dtype,
                      device=rows.device)
    return out.index_add(0, idx.long(), rows)


def gcn(P, name, x, s, r, w, n, pr):
    """GCN layer: D^-1/2 (A + I) D^-1/2 X W + b, weighted in-degrees."""
    wd = (torch.ones(s.shape[0], device=x.device) if w is None
          else w.float())
    deg = index_sum(wd, r, n) + 1.0
    dis = torch.rsqrt(deg)
    xw = linear(x, P[name + ".lin.weight"], None, pr)
    xs = pr(xw * dis[:, None])
    msg = xs[s.long()]
    if w is not None:
        msg = msg * w[:, None]
    agg = index_sum(msg, r, n)
    return agg * dis[:, None] + (dis * dis)[:, None] * xw + P[name + ".bias"]


def sage(P, name, x, s, r, n, pr):
    """GraphSAGE layer: W_l mean_{j->i} x_j + b + W_r x_i."""
    cnt = index_sum(torch.ones(s.shape[0], device=x.device), r, n)
    agg = index_sum(x[s.long()], r, n) / cnt.clamp(min=1.0)[:, None]
    return (linear(agg, P[name + ".lin_l.weight"], P[name + ".lin_l.bias"],
                   pr)
            + linear(x, P[name + ".lin_r.weight"], None, pr))


def gat(P, name, x, s, r, n, concat, pr):
    """GATv1 layer with self-loops, leaky_relu 0.2, softmax per receiver
    and head."""
    att_src, att_dst = P[name + ".att_src"], P[name + ".att_dst"]
    h, f = att_src.shape[1], att_src.shape[2]
    xw = linear(x, P[name + ".lin.weight"], None, pr).reshape(n, h, f)
    a_src = (xw * att_src).sum(-1)
    a_dst = (xw * att_dst).sum(-1)
    loop = torch.arange(n, device=x.device)
    s2 = torch.cat([s.long(), loop])
    r2 = torch.cat([r.long(), loop])
    lg = F.leaky_relu(a_src[s2] + a_dst[r2], 0.2)
    mx = torch.full((n, h), -torch.inf, device=x.device).scatter_reduce(
        0, r2[:, None].expand(-1, h), lg, "amax", include_self=True)
    ex = torch.exp(lg - mx[r2])
    alpha = ex / index_sum(ex, r2, n)[r2]
    out = index_sum(xw[s2] * alpha[:, :, None], r2, n)
    out = out.reshape(n, h * f) if concat else out.mean(dim=1)
    return out + P[name + ".bias"]


def hash32(seed, counters):
    """murmur3's 32-bit finaliser applied twice, as int64 values in
    [0, 2**32): the score head's dropout bits of ``counters`` under
    ``seed``."""
    m32 = 0xFFFFFFFF

    def mul(x, c):
        return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) \
            & m32

    def fmix(h):
        h = h ^ (h >> 16)
        h = mul(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        h = mul(h, 0xC2B2AE35)
        return h ^ (h >> 16)
    counters = counters.long()
    seed = seed.long() & m32
    inner = fmix(seed ^ 0x243F6A88 ^ mul(counters >> 32, 0x9E3779B9))
    return fmix((counters & m32) ^ inner)


def head(P, h, s, r, rate, seed, pr, slot0=0, block=HEAD_BLOCK):
    """sigmoid(fc2(dropout(relu(fc1([h_s * h_r || h_s - h_r]))))) of the
    edges (s, r); slot e of the list keeps hidden unit k when
    hash32(seed, (slot0 + e) * K + k) >= floor(rate * 2**32). In blocks
    of ``block`` edges."""
    pre = "edge_prob_mlp.head."
    w1, b1 = P[pre + "fc1.weight"], P[pre + "fc1.bias"]
    w2, b2 = P[pre + "fc2.weight"], P[pre + "fc2.bias"]
    k = w1.shape[0]
    h = pr(h)
    thresh = min(int(rate * (1 << 32)), (1 << 32) - 1)
    outs = []
    for a in range(0, s.shape[0], block):
        hu, hv = h[s[a:a + block].long()], h[r[a:a + block].long()]
        z = torch.relu(linear(torch.cat([hu * hv, hu - hv], 1), w1, b1, pr))
        if rate > 0:
            e = torch.arange(slot0 + a, slot0 + a + hu.shape[0],
                             device=h.device)
            keep = hash32(seed, e[:, None] * k
                          + torch.arange(k, device=h.device)) >= thresh
            z = torch.where(keep, z / (1.0 - rate), 0.0)
        outs.append(torch.sigmoid(linear(z, w2, b2, pr)).squeeze(-1))
    return torch.cat(outs) if outs else h.new_zeros(0)


def dropout(x, rate, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Model:
    """The backbone and scorer of a configuration, over a parameter dict
    keyed by the program's parameter names; each architecture's layers
    in its module under ``benchmark/archs/``."""

    def __init__(self, cfg, params, pr=F32):
        self.cfg = cfg
        self.rate = cfg["drop_rate"]
        self.P = params
        self.pr = pr

    def encode(self, x, s, r, n, gen):
        """Scorer embeddings; ``gen`` None: evaluation (no dropout)."""
        return self.pr(archs.scorer(self.cfg).encode(self, x, s, r, n, gen))

    def head(self, h, s, r, seed, slot0=0):
        rate = 0.0 if seed is None else self.rate
        return head(self.P, h, s, r, rate, seed, self.pr, slot0)

    def forward(self, x, s, r, w, n, gen):
        """Backbone logits; ``gen`` None: evaluation (no dropout)."""
        return archs.backbone(self.cfg).forward(self, x, s, r, w, n, gen)


# ------------------------------------------------------------------ losses

def masked_ce(logits, y, mask):
    nll = F.cross_entropy(logits.float(), y.long(), reduction="none")
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def accuracy(logits, y, mask):
    m = mask.float()
    hit = (logits.argmax(-1) == y.long()).float()
    return (hit * m).sum() / m.sum().clamp(min=1.0)


def reg1(p, flags):
    labels = ((flags >> 1) & 1).float()
    valid = (flags & 1).float()
    bce = F.binary_cross_entropy(p, labels, reduction="none")
    mean = (bce * valid).sum() / valid.sum().clamp(min=1.0)
    return torch.where((labels * valid).sum() > 1.0, mean, 0.0)


def reg2(p, s, r, out, valid):
    a, b = out[s.long()], out[r.long()]

    def norm(v):
        return torch.sqrt((v * v).sum(-1).clamp(min=1e-16)).clamp(min=1e-8)
    sq = (p - (a * b).sum(-1) / (norm(a) * norm(b))) ** 2
    m = valid.float()
    return (sq * m).sum() / m.sum().clamp(min=1.0)


# ----------------------------------------------------------------- samplers

def gumbel_keys(gen, probs, mask):
    u = torch.rand(probs.shape, generator=gen, device=probs.device)
    u = u.clamp(min=TINY)
    keys = torch.log(probs.float().clamp(min=1e-30)) - torch.log(-torch.log(u))
    return torch.where(mask, keys, -torch.inf)


def top(keys, q):
    return torch.topk(keys, q).indices


def prior_draw(gen, prior, mask, q):
    """q edges ~ softmax(prior) without replacement (the conditional gate's
    random subgraph)."""
    p = torch.softmax(torch.where(mask, prior, -torch.inf), 0)
    return top(gumbel_keys(gen, p, mask), q)


def learned_samples(probs, prior, mask, beta, istest):
    p = torch.where(mask, probs, 0.0)
    p = p / (p.sum() + EPS_NORM)
    if not istest:
        p = (1.0 - beta) * p + beta * torch.where(mask, prior, 0.0)
    return p


def uniform_draw(gen, mask, q):
    u = torch.rand(mask.shape, generator=gen, device=mask.device)
    return top(torch.where(mask, u.clamp(min=TINY), -torch.inf), q)


def draw_seed(gen, device):
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device,
                         dtype=torch.int32)


# -------------------------------------------------------------- train step

def learned_step(model, cfg, g, gen, q, winners, gate):
    """One hybrid_rescore step's loss on batch ``g`` with the draws of
    ``gen``. ``winners``: the program's q tile slots in its order, or None
    to take the reference's own; ``gate``: the program's conditional gate,
    or None for the reference's. Returns (total, facts), facts holding
    the reference's own winners and gate."""
    n = g["x"].shape[0]
    x, y, trm = g["x"], g["y"], g["train_mask"]
    rand_idx = prior_draw(gen, g["prob"], g["edge_mask"], q)
    aux = g["edge_aux"][rand_idx]
    rs, rr = aux[:, 0], aux[:, 1]
    h = model.encode(x, rs, rr, n, gen)
    seed_tiles = draw_seed(gen, x.device)
    t, b = g["tile_t"], g["tile_b"]
    blk = torch.arange(g["tile_ls"].shape[0], device=x.device) // b
    gs = g["tile_su"].long()[blk] * t + g["tile_ls"]
    gr = g["tile_rv"].long()[blk] * t + g["tile_lr"]
    with torch.no_grad():
        probs_t = model.head(h.detach(), gs, gr, seed_tiles)
        samples = learned_samples(probs_t, g["tile_prob"], g["tile_mask"],
                                  cfg["degree_bias_coef"], False)
        own = torch.sort(top(gumbel_keys(gen, samples, g["tile_mask"]),
                             q)).values
    idx_t = own if winners is None else winners
    sel = g["tile_aux"][idx_t.long()]
    ss, sr, flags = sel[:, 0], sel[:, 1], sel[:, 2]
    valid = (flags & 4) > 0
    w = model.head(h, ss, sr, draw_seed(gen, x.device))
    w = torch.where(valid, w, 0.0)
    out = model.forward(x, ss, sr, w, n, gen)
    loss = masked_ce(out, y, trm)
    if cfg["reg1"]:
        loss = loss + cfg["regularizer1_coef"] * reg1(w, flags)
    if cfg["reg2"]:
        loss = loss + cfg["consist_reg_coef"] * reg2(w, ss, sr, out, valid)
    rout = model.forward(x, rs, rr, None, n, gen)
    lf1, rf1 = accuracy(out, y, trm), accuracy(rout, y, trm)
    own_gate = bool(lf1 > rf1)
    use = own_gate if gate is None else bool(gate)
    total = loss if use else masked_ce(rout, y, trm)
    return total, dict(winners=own, gate=own_gate, lf1=float(lf1),
                       rf1=float(rf1), n_train=int(trm.sum()), used_gate=use)


def small_step(model, cfg, g, gen):
    """A partition whose valid edges are q or fewer: the backbone on every
    edge of the batch, padding included, masked CE (the learned mode
    updates the gnn group alone)."""
    n = g["x"].shape[0]
    out = model.forward(g["x"], g["senders"], g["receivers"], None, n, gen)
    return masked_ce(out, g["y"], g["train_mask"]), {}


def random_step(model, cfg, g, gen, q):
    """One random-mode step's loss: the backbone on a uniform q-subset."""
    n = g["x"].shape[0]
    idx = uniform_draw(gen, g["edge_mask"], q)
    aux = g["edge_aux"][idx]
    out = model.forward(g["x"], aux[:, 0], aux[:, 1], None, n, gen)
    return masked_ce(out, g["y"], g["train_mask"]), {}


# -------------------------------------------------------------------- Adam

def gnn_token(gnn):
    return {"GCN": "gcn", "Cheb": "gcn", "GIN": "GIN", "GAT": "GAT"}[gnn]


class DualAdam:
    """Three Adam groups over name-filtered parameters: ``gnn`` (names
    with the backbone's token), ``edge`` (names with 'edge_prob_mlp') and
    ``all`` (weight decay; the baseline modes). The learned step updates
    gnn always and edge where the gate holds; overlapping names get both
    updates; a skipped group's moments and count stay."""

    def __init__(self, names, gnn, lr, weight_decay, b1=0.9, b2=0.999,
                 eps=1e-8):
        tok = gnn_token(gnn)
        self.names = list(names)
        self.groups = {"gnn": [tok in n for n in self.names],
                       "edge": ["edge_prob_mlp" in n for n in self.names],
                       "all": [True] * len(self.names)}
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay, b1,
                                                        b2, eps)
        self.state = {}

    def _update(self, grp, params, grads, wd=0.0):
        mask = self.groups[grp]
        st = self.state.setdefault(grp, dict(
            t=0, m=[torch.zeros_like(p) if k else None
                    for p, k in zip(params, mask)],
            v=[torch.zeros_like(p) if k else None
               for p, k in zip(params, mask)]))
        st["t"] += 1
        bc1 = 1.0 - self.b1 ** st["t"]
        bc2 = 1.0 - self.b2 ** st["t"]
        ups = []
        for i, (p, g) in enumerate(zip(params, grads)):
            if not mask[i]:
                ups.append(None)
                continue
            if wd:
                g = g + wd * p
            st["m"][i] = self.b1 * st["m"][i] + (1.0 - self.b1) * g
            st["v"][i] = self.b2 * st["v"][i] + (1.0 - self.b2) * g * g
            ups.append(-self.lr * (st["m"][i] / bc1)
                       / (torch.sqrt(st["v"][i] / bc2) + self.eps))
        return ups

    def step(self, params, grads, mode, gate=True, small=False):
        if mode == "learned":
            lists = ([self._update("edge", params, grads)]
                     if gate and not small else [])
            lists.append(self._update("gnn", params, grads))
        else:
            lists = [self._update("all", params, grads, self.wd)]
        with torch.no_grad():
            for ups in lists:
                for p, u in zip(params, ups):
                    if u is not None:
                        p.add_(u)


# ----------------------------------------------------------------- serving

@torch.no_grad()
def predict(model, cfg, g, gen, q, draws, small=False):
    """Mean logits of ``draws`` sampled subgraphs in evaluation semantics:
    the scorer over every edge, then per draw the Gumbel top-q of the
    normalised probabilities and the backbone on those edges weighted by
    their probabilities. ``small`` (valid edges <= q) or E <= q: the
    backbone on the whole padded graph, once."""
    n = g["x"].shape[0]
    s, r = g["senders"], g["receivers"]
    if small or s.shape[0] <= q:
        return model.forward(g["x"], s, r, None, n, None)
    h = model.encode(g["x"], s, r, n, None)
    probs = model.head(h, s, r, None)
    samples = learned_samples(probs, None, g["edge_mask"], 0.0, True)
    total = None
    for _ in range(draws):
        idx = top(gumbel_keys(gen, samples, g["edge_mask"]), q)
        out = model.forward(g["x"], s[idx], r[idx], probs[idx], n, None)
        total = out if total is None else total + out
    return total / draws


@torch.no_grad()
def evaluate(model, cfg, g, gen, q, draws, mode, small):
    """One partition's eval: the correct predictions in each of the
    train, val and test masks, and the masks' sizes. Learned mode as
    ``predict``; random mode the mean logits of ``draws`` uniform
    q-subsets, unweighted."""
    if mode == "learned" or small or g["senders"].shape[0] <= q:
        logits = predict(model, cfg, g, gen, q, draws, small)
    else:
        n = g["x"].shape[0]
        s, r = g["senders"], g["receivers"]
        logits = None
        for _ in range(draws):
            idx = uniform_draw(gen, g["edge_mask"], q)
            out = model.forward(g["x"], s[idx], r[idx], None, n, None)
            logits = out if logits is None else logits + out
        logits = logits / draws
    hit = logits.argmax(-1) == g["y"].long()
    out = {}
    for split in ("train", "val", "test"):
        m = g[f"{split}_mask"]
        out[split] = (int((hit & m).sum()), int(m.sum()))
    return out


def param_norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog, ref, keep):
    """The worst leaf ``keep`` names of |‖prog‖ - ‖ref‖| / max(‖ref‖,
    median leaf's ‖ref‖): (gap, leaf)."""
    norms = {k: param_norm(ref[k]) for k in keep}
    if not norms:
        return 0.0, ""
    med = float(np.median(list(norms.values())))
    gaps = {k: abs(param_norm(prog[k]) - norms[k]) / max(norms[k], med,
                                                           1e-30)
            for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def leaf_diffs(prog, ref, keep):
    """The worst leaf ``keep`` names of ‖prog - ref‖ / ‖ref‖: (gap,
    leaf)."""
    if not keep:
        return 0.0, ""
    gaps = {k: param_norm(prog[k].float() - ref[k].float())
            / max(param_norm(ref[k]), 1e-30) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def make_weights(shapes, seed, device):
    """Every parameter from one uniform draw on ``device``: weights (two
    or more dims) glorot-uniform, biases zero. ``shapes``: name -> shape,
    in the model's order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        if len(shape) >= 2:
            fan_out, fan_in = ((shape[0], shape[1]) if len(shape) == 2
                               else (shape[-1], shape[-2]))
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            out[name] = (flat[off:off + k] * lim).reshape(shape).clone()
        else:
            out[name] = torch.zeros(shape, device=device)
        off += k
    return out

"""How the fused SpMM (K8, ``csrc/spmm.cu``) cuts a call, on the CPU.

``spmm_plan`` is a plain function of the shapes, so its limits, its route
choice and its coverage of the work are checked here, with a numpy
emulation of the tile route's binning (``spmm_bin_plain``) and the tile
route's schedule in plain torch (``spmm_tiles_plain``: densify each 64 x 64
tile in f32, split it into bf16 hi + lo, multiply, sum the parts) held to
the plain version and to the Pallas kernel in interpret mode. The kernels
themselves run only on the card (tests/test_torch_cuda.py).

Tolerance of every value comparison: 1e-5 * sum|w x| per row + 1e-6, as on
the card (f32 sums in another order; hi + lo keeps a summed pair weight to
a relative 2^-17)."""
import collections
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.ops.spmm_pallas import _spmm_pallas_impl
from sgs_gnn_tpu_torch.ops.scatter import SMEM_LIMIT

# the module (ops/__init__ binds the name spmm to the function)
sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(rng, n, e, order, lo=0, hi=None):
    """(senders, receivers) int32: receiver-sorted, or that list reversed
    (the backward's, receivers unsorted); senders drawn from [lo, hi)."""
    hi = n if hi is None else hi
    s = rng.integers(lo, hi, e).astype(np.int32)
    r = np.sort(rng.integers(0, n, e)).astype(np.int32)
    return (r, s) if order == "reversed" else (s, r)


def _inputs(rng, n, e, f, order, weighted, lo=0, hi=None):
    s, r = _edges(rng, n, e, order, lo, hi)
    w = (rng.random(e) if weighted else np.ones(e)).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return _t(s), _t(r), _t(w), _t(x).to(torch.bfloat16)


def _assert_within(got, s, r, w, x, n):
    ref = sp.spmm_fused_plain(s, r, w, x, n)
    tol = 1e-5 * sp.spmm_fused_plain(s, r, w, x.abs(), n) + 1e-6
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = (got - ref).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", [132, 114])
def test_spmm_plan_shared_memory_within_limit(itemsize, sms):
    for n in (1, 37, 64, 65, 300, 2048, 5760, 5761, 20_000):
        for f in (1, 8, 16, 17, 41, 64, 100, 256, 257, 602):
            for e in (1, 1000, 65_536, 1_000_000):
                plan = sp.spmm_plan(n, f, e, itemsize, sms)
                assert plan.smem_bytes <= SMEM_LIMIT == 232_448
                assert plan.bin_smem_bytes <= SMEM_LIMIT
                if plan.route == "tiles":
                    assert plan.smem_bytes == sp.tile_smem(plan.width)
                    assert plan.bin_smem_bytes == sp.bin_smem(plan.bins)
                    # the blocks the grid counts on fit one SM together
                    per_sm = sp.parts_per_sm(plan.width)
                    assert per_sm * (plan.smem_bytes + 1024) <= 233_472
                    assert 1 <= plan.parts <= -(-per_sm * sms // plan.slices)


@pytest.mark.parametrize("n", [64, 300, 2048, 5760])
def test_spmm_plan_route_threshold(n):
    """Tiles for bf16 x from MIN_TILE_EDGES edges per tile on average;
    the gather route below it, for f32 x, and for more tiles than the
    binning's shared histogram holds."""
    bins = (-(-n // sp.TILE)) ** 2
    need = sp.MIN_TILE_EDGES * bins
    assert sp.spmm_plan(n, 256, need - 1, 2).route == "gather"
    assert sp.spmm_plan(n, 256, need, 2).route == "tiles"
    assert sp.spmm_plan(n, 256, need, 2).bins == bins
    assert sp.spmm_plan(n, 256, 100 * need, 4).route == "gather"
    big = 91 * sp.TILE          # 91^2 = 8281 tiles > MAX_BINS
    assert sp.spmm_plan(big, 41, 10**9, 2).route == "gather"


@pytest.mark.parametrize("f", [1, 8, 16, 41, 64, 65, 100, 192, 256, 300,
                               602])
def test_spmm_plan_columns(f):
    """Each column lies in exactly one slice; a block's width is one the
    kernel is built for, F rounded up to 16 (each warpgroup's half a wgmma
    width, a multiple of 8), 256 in slices above that."""
    plan = sp.spmm_plan(300, f, 10**6, 2)
    assert plan.route == "tiles" and plan.width in sp.WIDTHS
    assert plan.width % 16 == 0
    assert plan.width >= min(-(-f // 16) * 16, 256)
    cols = np.zeros(f, int)
    for c in range(plan.slices):
        cols[c * plan.width:(c + 1) * plan.width] += 1
    assert (cols == 1).all()
    gather = sp.spmm_plan(300, f, 10**6, 4)
    assert gather.slices * gather.width >= f > (gather.slices - 1) \
        * gather.width


def _walk(off, begin, end):
    """The tiles and edge ranges a tile block walks (csrc/spmm.cu
    spmm_tile_kernel's find), emulated."""
    t = int(np.searchsorted(off, begin, side="right")) - 1
    out = []
    while t < len(off) - 1 and off[t] < end:
        lo, hi = max(off[t], begin), min(off[t + 1], end)
        if hi > lo:
            out.append((t, lo, hi))
        t += 1
    return out


@pytest.mark.parametrize("n,e", [(64, 4096), (200, 20_000), (300, 6000)])
@pytest.mark.parametrize("sms", [132, 7])
def test_spmm_plan_covers_every_edge_and_receiver_once(n, e, sms):
    """The parts of a column slice take every binned edge once; the tiles
    they walk cover [0, N) x [0, N) in receiver blocks of 64, each receiver
    in one block."""
    rng = np.random.default_rng(3)
    s, r, w, _ = _inputs(rng, n, e, 41, "sorted", True, -2, n + 2)
    plan = sp.spmm_plan(n, 41, e, 2, sms)
    assert plan.route == "tiles"
    off = sp.spmm_bin_plain(s, r, w, n)[0].numpy()
    total = int(off[-1])
    seen = np.zeros(total, int)
    sblocks = -(-n // sp.TILE)
    for p in range(plan.parts):
        begin, end = sp.part_range(total, p, plan.parts)
        for t, lo, hi in _walk(off, begin, end):
            seen[lo:hi] += 1
            assert off[t] <= lo < hi <= off[t + 1]
            assert 0 <= t < sblocks * sblocks
    assert (seen == 1).all()
    rows = np.zeros(n, int)
    for rb in range(sblocks):
        rows[rb * sp.TILE:(rb + 1) * sp.TILE] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("order", ["sorted", "reversed", "random"])
def test_spmm_bin_plain_matches_numpy_emulation(order):
    """Every in-range edge lands in exactly one bin, its tile (receiver
    block major, sender block minor), bins in order; edges with an endpoint
    outside [0, N) are dropped; the weight is rounded to bf16."""
    rng = np.random.default_rng(4)
    n, e = 200, 5000
    s = rng.integers(-3, n + 3, e).astype(np.int32)
    r = rng.integers(-3, n + 3, e).astype(np.int32)
    if order == "sorted":
        r = np.sort(r)
    elif order == "reversed":
        s, r = np.sort(r), s
    w = rng.random(e).astype(np.float32)
    off, at, wb = sp.spmm_bin_plain(_t(s), _t(r), _t(w), n)
    off, at, wb = off.numpy(), at.numpy(), wb.numpy()
    keep = (s >= 0) & (s < n) & (r >= 0) & (r < n)
    sblocks = -(-n // sp.TILE)
    key = (r[keep] // sp.TILE) * sblocks + s[keep] // sp.TILE
    assert off[0] == 0 and off[-1] == keep.sum() == len(at)
    np.testing.assert_array_equal(np.diff(off),
                                  np.bincount(key, minlength=sblocks ** 2))
    w_bf16 = torch.from_numpy(w[keep]).to(torch.bfloat16).float().numpy()
    place = (r[keep] % sp.TILE) * sp.TILE + s[keep] % sp.TILE
    for t in range(sblocks ** 2):
        got = sorted(zip(at[off[t]:off[t + 1]], wb[off[t]:off[t + 1]]))
        want = sorted(zip(place[key == t], w_bf16[key == t]))
        assert got == want, t


@pytest.mark.parametrize("order", ["sorted", "reversed"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,f,e", [(64, 8, 4096), (200, 41, 20_000),
                                   (300, 64, 12_000)])
def test_spmm_tiles_plain_matches_plain(order, weighted, n, f, e):
    """The tile schedule against K8's plain version: N a multiple of 64 and
    not, F=41 padded to a width of 48, endpoints out of range, the
    receiver-sorted list and its reversal."""
    rng = np.random.default_rng(5)
    s, r, w, x = _inputs(rng, n, e, f, order, weighted, -1, n + 1)
    plan = sp.spmm_plan(n, f, e, 2)
    assert plan.route == "tiles" and plan.parts > 1
    _assert_within(sp.spmm_tiles_plain(s, r, w, x, n, plan), s, r, w, x, n)
    # one part: no split-K
    _assert_within(sp.spmm_tiles_plain(s, r, w, x, n, plan._replace(parts=1)),
                   s, r, w, x, n)


@pytest.mark.parametrize("order", ["sorted", "reversed"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,f", [(130, 41), (64, 16)])
def test_spmm_tiles_plain_matches_pallas(order, weighted, n, f):
    """The tile schedule against the Pallas kernel in interpret mode (all
    endpoints in range: JAX clamps the others)."""
    rng = np.random.default_rng(6)
    e = 4500
    s, r, w, x = _inputs(rng, n, e, f, order, weighted)
    want = _spmm_pallas_impl(jnp.asarray(s.numpy()), jnp.asarray(r.numpy()),
                             jnp.asarray(w.numpy()),
                             jnp.asarray(x.float().numpy()).astype(
                                 jnp.bfloat16), n, interpret=True)
    got = sp.spmm_tiles_plain(s, r, w, x, n)
    tol = 1e-5 * sp.spmm_fused_plain(s, r, w, x.abs(), n) + 1e-6
    assert bool(((got - torch.from_numpy(np.asarray(want))).abs()
                 <= tol).all())


@pytest.mark.parametrize("repeats,weight", [(300, 1.0), (301, 1.0),
                                            (300, 0.3)])
def test_spmm_tiles_plain_holds_a_repeated_pair(repeats, weight):
    """One (receiver, sender) pair repeated: its summed weight is not a
    bf16 number (301 ones, 300 x bf16(0.3)); hi + lo holds it within the
    tolerance, where hi alone misses it."""
    rng = np.random.default_rng(7)
    n, f, e = 128, 41, 9000
    s, r, w, x = _inputs(rng, n, e, f, "sorted", True)
    s[:repeats], r[:repeats], w[:repeats] = 5, 70, weight
    x[5] = 1.0
    plan = sp.spmm_plan(n, f, e, 2)
    got = sp.spmm_tiles_plain(s, r, w, x, n, plan)
    _assert_within(got, s, r, w, x, n)
    panel = torch.tensor(weight).to(torch.bfloat16).float() * repeats
    if panel.to(torch.bfloat16).float() != panel:    # hi alone is short
        ref = sp.spmm_fused_plain(s, r, w, x, n)
        tol = 1e-5 * sp.spmm_fused_plain(s, r, w, x.abs(), n) + 1e-6
        short = float((panel - panel.to(torch.bfloat16).float()).abs())
        assert short > float(tol[70].max())
        assert float((got[70] - ref[70]).abs().max()) <= float(tol[70].min())


# ------------------------------------------- the "auto" backend's route
#
# spmm(backend="auto") takes K8 ("k8_tiles") only for a call on a card that
# records no autograd graph and whose plan is "tiles"; every other call
# keeps the gather, the weight multiply and K1 ("gather_k1"), whose values
# are the route's before K8 was taken, bit for bit.

def _gather_k1(s, r, w, x, n):
    """The "gather_k1" route as written before the route pick."""
    from sgs_gnn_tpu_torch.ops.edge_gather import gather_rows
    from sgs_gnn_tpu_torch.ops.scatter import scatter_add
    msgs = gather_rows(x, s)
    if w is not None:
        msgs = msgs * w[:, None].to(x.dtype)
    return scatter_add(msgs, r, n).to(x.dtype)


def _padded_inputs(n, e, f, weighted, pad=500):
    """A tiles-plan shape (bf16) whose last ``pad`` edges are the padding
    self-loops on node 0 with weight 0, as ``Graph.build`` pads."""
    rng = np.random.default_rng(11)
    s, r, w, x = _inputs(rng, n, e, f, "sorted", True)
    s[-pad:], r[-pad:], w[-pad:] = 0, 0, 0.0
    assert sp.spmm_plan(n, f, e, 2).route == "tiles"
    return s, r, (w if weighted else None), x


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("records_grad", [False, True])
@pytest.mark.parametrize("plan_route", ["tiles", "gather", ""])
def test_auto_route_is_a_function_of_device_grad_and_plan(
        device_type, records_grad, plan_route):
    want = ("k8_tiles" if (device_type, records_grad, plan_route)
            == ("cuda", False, "tiles") else "gather_k1")
    assert sp.auto_route(device_type, records_grad, plan_route) == want


@pytest.mark.parametrize("case,want", [
    ("no_grad", (False, "tiles")),
    ("grad_on_nothing_requires_it", (False, "tiles")),
    ("x_requires_grad", (True, "tiles")),
    ("weights_require_grad", (True, "tiles")),
    ("weights_require_grad_under_no_grad", (False, "tiles")),
    ("f32_x", (False, "gather")),
    ("sparse", (False, "gather")),
    ("more_rows_than_nodes", (False, "")),
])
def test_spmm_auto_asks_the_route_what_the_call_shows(monkeypatch, case,
                                                      want):
    """``spmm`` hands ``auto_route`` the device type, whether the call
    records a graph (grad mode on and x or the weights requiring grad) and
    the plan's route of a square A_w (none where x has more rows than
    there are receivers, as a halo's extended table)."""
    n, e, f = 300, 12_000, 41
    s, r, w, x = _padded_inputs(n, e, f, True)
    asked = []
    monkeypatch.setattr(sp, "auto_route",
                        lambda *a: asked.append(a) or "gather_k1")
    rows = n
    if case == "x_requires_grad":
        x = x.clone().requires_grad_()
    elif case.startswith("weights_require_grad"):
        w = w.clone().requires_grad_()
    elif case == "f32_x":
        x = x.float()
    elif case == "sparse":
        s, r, w = s[:1000], r[:1000], w[:1000]
    elif case == "more_rows_than_nodes":
        x = torch.cat([x, x[:7]])
    grad = not case.endswith("no_grad")
    with torch.set_grad_enabled(grad):
        sp.spmm(s, r, w, x, rows)
    assert asked == [("cpu",) + want]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("grad", ["no_grad", "autograd"])
def test_spmm_auto_on_cpu_is_the_gather_k1_route_bit_for_bit(weighted, grad):
    """On the CPU the route is "gather_k1", with or without gradients: the
    values (and under autograd dx and dw) are those of the gather, the
    multiply and K1 exactly, at a shape whose plan is "tiles"; the call is
    counted on its route."""
    from sgs_gnn_tpu_torch.ops import _build
    n, e, f = 300, 12_000, 64
    s, r, w, x = _padded_inputs(n, e, f, weighted)
    if grad == "autograd":
        x = x.clone().requires_grad_()
        if w is not None:
            w = w.clone().requires_grad_()
    routes0 = collections.Counter(_build.ROUTES)
    with torch.set_grad_enabled(grad == "autograd"):
        got = sp.spmm(s, r, w, x, n)
        want = _gather_k1(s, r, w, x, n)
    assert _build.ROUTES - routes0 == {("spmm", "gather_k1"): 1}
    assert got.dtype == x.dtype and torch.equal(got, want)
    if grad == "autograd":
        cot = torch.from_numpy(np.random.default_rng(2).normal(
            size=(n, f)).astype(np.float32)).to(x.dtype)
        wrt = [t for t in (x, w) if t is not None]
        for a, b in zip(torch.autograd.grad(got, wrt, cot),
                        torch.autograd.grad(want, wrt, cot)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ids", [torch.int32, torch.int64])
def test_spmm_auto_on_the_k8_route_is_k8(monkeypatch, weighted, ids):
    """Where the route is "k8_tiles" (forced here: the CPU never takes it)
    the call is K8's (on the CPU its plain version): f32 products of the
    x-rounded weights, f32 sums, the padding self-loops counted as they
    come (weight 0, or 1 unweighted), int64 ids narrowed to int32, the
    output in x's dtype; counted on its route."""
    from sgs_gnn_tpu_torch.ops import _build
    n, e, f = 300, 12_000, 41
    s, r, w, x = _padded_inputs(n, e, f, weighted)
    monkeypatch.setattr(sp, "auto_route", lambda *a: "k8_tiles")
    routes0 = collections.Counter(_build.ROUTES)
    with torch.no_grad():
        got = sp.spmm(s.to(ids), r.to(ids), w, x, n)
    assert _build.ROUTES - routes0 == {("spmm", "k8_tiles"): 1}
    ones = torch.ones(e, dtype=torch.float32)
    want = sp.spmm_fused_plain(s, r, ones if w is None else w, x, n)
    assert got.dtype == x.dtype and torch.equal(got, want.to(x.dtype))

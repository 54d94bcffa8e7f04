"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a card. These cover the ragged
and odd shapes that the full-width run in ``chip_smoke.py`` does not: F not
a multiple of the column tile, K not a multiple of the hidden tile, q not a
multiple of the edge tile, ids out of range, N above the shared-memory
histogram, each route of the row scatter (K1) and the degree sum (K2) with
hub-skewed ids and long runs, N not a multiple of the tile rows, padding
slots; for the sorted scatter a ragged E, padding ids and a band too narrow (kernel and
plain version drop the same items); for the fused SpMM both routes (tiles,
gather) with sorted and unsorted receivers, heavy duplicates, endpoints out
of range, an empty receiver block, no edges, its backward and a CUDA graph
of both. The head
kernels run with dropout: kernel and plain version draw the same mask from
the same seed, so only the order of f32 sums (and, in bf16, the roundings
that follow them) separates them. On the machine with the card (no JAX
there, so without the repository's conftest):

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import collections
import importlib
import re
import time

import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch.ops import dropout as dr
from sgs_gnn_tpu_torch.ops import edge_gather as eg
from sgs_gnn_tpu_torch.ops import scatter as sc
from sgs_gnn_tpu_torch.ops import score_sampled as ss
from sgs_gnn_tpu_torch.ops import score_tiles as st
from sgs_gnn_tpu_torch.ops._build import LAUNCHES

# the module (ops/__init__ binds the name spmm to the function)
sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")

# (seed, counter, hash32) computed from csrc/common.cuh's definition; the
# same table is held against the torch twin in tests/test_torch_tiles.py
HASH32_TABLE = [(0, 0, 1107962638), (0, 1, 1320027387), (1, 0, 1613265885),
                (12345, 255, 2028518022), (2147483646, 272891903, 2596186920),
                (7, 4294967301, 2906286678), (99, 1099511640121, 4220018807)]

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); the CPU runs the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


F64 = torch.float64


def _sum_tol(abs_sum):
    # a kernel's f32 sums against the plain version's f64 sum of the same
    # terms (acc_dtype=F64, exact in any order): the kernel's own rounding
    # stays well under 1e-5 of the sum of magnitudes; a floor for empty rows
    return 1e-5 * abs_sum + 1e-6


def _assert_sums(got, ref, abs_sum, slack=0.0):
    """``got`` within ``_sum_tol(abs_sum)`` (+ ``slack``) of the f64
    reference ``ref``."""
    err = (got.double() - ref).abs()
    limit = _sum_tol(abs_sum) + slack
    assert bool((err <= limit).all()), float((err / limit).max())


def _one_launch(name, route, run):
    """Runs ``run()`` and checks that it launched ``name`` once, on
    ``route``, and nothing else."""
    from sgs_gnn_tpu_torch.ops._build import ROUTES
    before_l, before_r = dict(LAUNCHES), dict(ROUTES)
    out = run()
    torch.cuda.synchronize()
    after_l, after_r = dict(LAUNCHES), dict(ROUTES)
    assert after_l.pop(name) == before_l.pop(name, 0) + 1
    assert after_r.pop((name, route)) == before_r.pop((name, route), 0) + 1
    assert (after_l, after_r) == (before_l, before_r)
    return out


def _check_scatter(vals, ids, n):
    """One K1 call against the plain version: its route, and on the slab
    route the chunks per mode the kernel counted against the twin of its
    pick (``slab_chunk_sorted``)."""
    plan = sc.scatter_plan(n, vals.shape[1], vals.element_size(),
                           vals.shape[0], sc._sm_count(vals.device.index))
    sc.reset_slab_chunk_modes()
    out = _one_launch("scatter_add", plan.route,
                      lambda: sc.scatter_add(vals, ids, n))
    rows = (sc.slab_chunk_sorted(ids.cpu().numpy(), plan)
            if plan.route == "slab" else [])
    assert sc.slab_chunk_modes() == {"sort": len(rows) - int(sum(rows)),
                                     "rows": int(sum(rows))}
    assert out.dtype == torch.float32 and out.shape == (n, vals.shape[1])
    _assert_sums(out, sc.scatter_add_plain(vals, ids, n, acc_dtype=F64),
                 sc.scatter_add_plain(vals.abs(), ids, n, acc_dtype=F64))
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,order", [(37, 1001, 41, "random"),
                                         (2048, 20000, 256, "sorted"),
                                         (5, 333, 300, "random"),
                                         (64, 4096, 1, "sorted")])
def test_scatter_add_kernel(card, dtype, n, e, f, order):
    g = torch.Generator(device=card).manual_seed(0)
    vals = torch.randn(e, f, generator=g, device=card).to(dtype)
    ids = torch.randint(-1, n + 1, (e,), generator=g, device=card,
                        dtype=torch.int32)
    if order == "sorted":
        ids = ids.sort().values
    assert _check_scatter(vals, ids, n).route == "slab"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,ids_kind,route", [
    # the backbone's q=200k shapes: hub-skewed ids, E not a multiple of
    # the chunk, F=41 (82-byte bf16 rows, three slabs of 16 columns)
    (2048, 200_003, 256, "hub", "slab"),
    (2048, 100_001, 41, "hub", "slab"),
    (2048, 65_537, 256, "sorted", "slab"),
    # sorted chunks ("rows" mode) and unsorted ones ("sort") in one call
    (2048, 200_003, 256, "half_sorted", "slab"),
    # N above a slab of one sector: the direct route, 16-byte and element
    # layouts
    (5000, 50_001, 256, "hub", "direct"),
    (5000, 20_011, 41, "hub", "direct"),
    (100_000, 30_000, 64, "random", "direct")])
def test_scatter_add_routes(card, dtype, n, e, f, ids_kind, route):
    """Each route of K1, with ids in [-2, N+2): out-of-range ids dropped;
    "hub": half the items on one id, the rest uniform; "half_sorted": the
    first half sorted, the rest uniform."""
    if dtype == torch.float32 and n == 5000:
        route = "slab"           # 8 f32 columns (one sector) fit at N=5000
    g = torch.Generator(device=card).manual_seed(3)
    vals = torch.randn(e, f, generator=g, device=card).to(dtype)
    ids = torch.randint(-2, n + 2, (e,), generator=g, device=card,
                        dtype=torch.int32)
    if ids_kind == "hub":
        ids[torch.randperm(e, generator=g, device=card)[:e // 2]] = 7
    elif ids_kind == "sorted":
        ids = ids.sort().values
    elif ids_kind == "half_sorted":
        ids[:e // 2] = ids[:e // 2].sort().values
    plan = _check_scatter(vals, ids, n)
    assert plan.route == route
    if ids_kind == "half_sorted":
        rows = sc.slab_chunk_sorted(ids.cpu().numpy(), plan)
        assert rows.any() and not rows.all()
    assert e % plan.chunk_items != 0
    # a view 2 bytes off the 16-byte layout
    shifted = vals.reshape(-1)[1:1 + (e - 1) * f].reshape(e - 1, f)
    _check_scatter(shifted, ids[:-1], n)


def _padding_ids(kind, n, e, g, card):
    """Ids where whole blocks hold none in range: "all_out" (-1 or N
    only), "padding_block" (uniform, with 10,000 consecutive N in the
    middle: at least one whole K1 chunk and four whole K2 blocks)."""
    if kind == "all_out":
        ids = torch.randint(0, 2, (e,), generator=g, device=card,
                            dtype=torch.int32) * (n + 1) - 1
    else:
        ids = torch.randint(0, n, (e,), generator=g, device=card,
                            dtype=torch.int32)
        ids[e // 2 - 5000:e // 2 + 5000] = n
    return ids


@pytest.mark.parametrize("n,f,route", [(2048, 256, "slab"),
                                       (2048, 41, "slab"),
                                       (5000, 256, "direct")])
@pytest.mark.parametrize("ids_kind", ["all_out", "padding_block"])
def test_scatter_add_padding_ids(card, n, f, route, ids_kind):
    e = 60_001
    g = torch.Generator(device=card).manual_seed(4)
    vals = torch.randn(e, f, generator=g, device=card).to(torch.bfloat16)
    ids = _padding_ids(ids_kind, n, e, g, card)
    assert _check_scatter(vals, ids, n).route == route


@pytest.mark.parametrize("n", [2048, 20_000])
@pytest.mark.parametrize("ids_kind", ["all_out", "padding_block"])
def test_segment_sum_scalar_padding_ids(card, n, ids_kind):
    """K2 on both routes where whole blocks touch no node: a block of the
    shared route then has nothing to flush."""
    e = 100_003
    g = torch.Generator(device=card).manual_seed(5)
    w = torch.rand(e, generator=g, device=card)
    ids = _padding_ids(ids_kind, n, e, g, card)
    route = "shared" if n <= 12288 else "global"
    assert sc.segment_plan(n, e).items_per_block <= 5000
    out = _one_launch("segment_sum_scalar", route,
                      lambda: sc.segment_sum_scalar(w, ids, n))
    ref = sc.segment_sum_scalar_plain(w, ids, n, acc_dtype=F64)
    _assert_sums(out, ref, ref)
    if ids_kind == "all_out":
        assert not bool(out.any())


@pytest.mark.parametrize("n", [1, 2048, 12288, 12289, 100_000])
def test_segment_sum_scalar_kernel(card, n):
    e = 50_000
    g = torch.Generator(device=card).manual_seed(1)
    w = torch.rand(e, generator=g, device=card)
    ids = torch.randint(-1, n + 1, (e,), generator=g, device=card,
                        dtype=torch.int32)
    route = sc.segment_plan(n, e).route
    assert route == ("shared" if n <= 12288 else "global")
    out = _one_launch("segment_sum_scalar", route,
                      lambda: sc.segment_sum_scalar(w, ids, n))
    ref = sc.segment_sum_scalar_plain(w, ids, n, acc_dtype=F64)
    _assert_sums(out, ref, ref)
    ones = torch.ones_like(w)                  # counts are exact in f32
    assert torch.equal(sc.segment_sum_scalar(ones, ids, n),
                       sc.segment_sum_scalar_plain(ones, ids, n))


@pytest.mark.parametrize("n", [2048, 20_000])
@pytest.mark.parametrize("ids_kind", ["sorted_runs", "one_id", "hub"])
def test_segment_sum_scalar_runs(card, n, ids_kind):
    """K2 on both routes with runs of equal ids: sorted ids with runs of
    ~1000 items (longer than a warp and than one 32-item step), one id for
    every item, and half the items on one id (unsorted)."""
    e = 300_007
    g = torch.Generator(device=card).manual_seed(2)
    w = torch.rand(e, generator=g, device=card)
    ids = torch.randint(0, 300, (e,), generator=g, device=card,
                        dtype=torch.int32) * (n // 300)
    if ids_kind == "sorted_runs":
        ids = ids.sort().values
    elif ids_kind == "one_id":
        ids.fill_(n - 1)
    else:
        ids[torch.randperm(e, generator=g, device=card)[:e // 2]] = 5
    route = "shared" if n <= 12288 else "global"
    out = _one_launch("segment_sum_scalar", route,
                      lambda: sc.segment_sum_scalar(w, ids, n))
    ref = sc.segment_sum_scalar_plain(w, ids, n, acc_dtype=F64)
    _assert_sums(out, ref, ref)
    ones = torch.ones_like(w)
    assert torch.equal(sc.segment_sum_scalar(ones, ids, n),
                       sc.segment_sum_scalar_plain(ones, ids, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,block,band", [
    (2048, 100_003, 256, 1024, 0),      # ragged E, band = required_band
    (2048, 100_003, 256, 1024, 8),      # undersized band: items dropped
    (37, 5001, 41, 256, 0),             # F off the 16-byte layout
    (5, 333, 300, 64, 0),               # two column tiles
    (300, 20_000, 8, 1024, 16)])
def test_scatter_add_sorted_kernel(card, dtype, n, e, f, block, band):
    g = torch.Generator(device=card).manual_seed(7)
    vals = torch.randn(e, f, generator=g, device=card).to(dtype)
    ids = torch.randint(0, n, (e,), generator=g, device=card,
                        dtype=torch.int32).sort().values
    if band == 0:
        band = sc.required_band(ids.cpu().numpy(), block)
    # padding ids at the end, as the TPU wrapper pads: N and N + band
    ids[-5:] = n
    ids[-2:] = n + band
    keep = sc.sorted_band_keep(ids, n, band, block)
    assert not bool(keep[-5:].any())
    # the second case is a view 16-byte misaligned: the element layout
    shifted = vals.reshape(-1)[1:1 + (e - 1) * f].reshape(e - 1, f)
    for v, i in ((vals, ids), (shifted, ids[:-1])):
        before = LAUNCHES["scatter_add_sorted"]
        out = sc.scatter_add_sorted(v, i, n, band, block)
        torch.cuda.synchronize()
        assert LAUNCHES["scatter_add_sorted"] == before + 1
        assert out.dtype == torch.float32 and out.shape == (n, f)
        _assert_sums(out, sc.scatter_add_sorted_plain(v, i, n, band, block,
                                                      acc_dtype=F64),
                     sc.scatter_add_sorted_plain(v.abs(), i, n, band, block,
                                                 acc_dtype=F64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [41, 256])
@pytest.mark.parametrize("order", ["sorted", "reversed"])
def test_spmm_fused_kernel(card, dtype, f, order):
    n, e = 2048, 50_001
    g = torch.Generator(device=card).manual_seed(8)
    s = torch.randint(-1, n + 1, (e,), generator=g, device=card,
                      dtype=torch.int32)
    r = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32).sort().values
    if order == "reversed":                     # the backward's edge list
        s, r = r, s
    w = torch.rand(e, generator=g, device=card, requires_grad=True)
    x = torch.randn(n, f, generator=g, device=card).to(dtype) \
        .requires_grad_()
    before = LAUNCHES["spmm_fused"]
    out = sp.spmm(s, r, w, x, n, backend="fused")
    torch.cuda.synchronize()
    assert LAUNCHES["spmm_fused"] == before + 1
    assert out.dtype == dtype
    ref = sp.spmm_fused_plain(s, r, w.detach(), x.detach(), n,
                              acc_dtype=F64)
    abs_sum = sp.spmm_fused_plain(s, r, w.detach(), x.detach().abs(), n,
                                  acc_dtype=F64)
    _assert_sums(sp._spmm_fused(s, r, w.detach(), x.detach(), n), ref,
                 abs_sum)
    # the result is cast to x's type: one rounding of the f32 sums
    _assert_sums(out, ref, abs_sum, 2 ** -8 * ref.abs())
    cot = torch.randn(n, f, generator=g, device=card).to(dtype)
    before = LAUNCHES["spmm_fused"]
    dw, dx = torch.autograd.grad(out, (w, x), cot)
    assert LAUNCHES["spmm_fused"] == before + 1     # dx: K8, reversed edges
    dx_ref = sp.spmm_fused_plain(r, s, w.detach(), cot, n, acc_dtype=F64)
    _assert_sums(dx, dx_ref, sp.spmm_fused_plain(r, s, w.detach(), cot.abs(),
                                                 n, acc_dtype=F64),
                 2 ** -8 * dx_ref.abs())
    dw_ref = torch.sum(sc.rows_at(x.detach(), s, n)
                       * sc.rows_at(cot, r, n), dim=-1).float()
    assert torch.equal(dw, dw_ref)


def _check_spmm(s, r, w, x, n, route):
    """One K8 call on ``route`` (launch and route counted once) against the
    plain version."""
    plan = sp.spmm_plan(n, x.shape[1], s.shape[0], x.element_size(),
                        sc._sm_count(x.device.index))
    assert plan.route == route
    out = _one_launch("spmm_fused", route,
                      lambda: sp._spmm_fused(s, r, w, x, n))
    ref = sp.spmm_fused_plain(s, r, w, x, n, acc_dtype=F64)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _assert_sums(out, ref, sp.spmm_fused_plain(s, r, w, x.abs(), n,
                                               acc_dtype=F64))
    return out


# (n, e, f, dtype, route): the tile route from 64 edges per 64 x 64 tile
# (bf16), the gather route below it and for f32 x (test_spmm_fused_kernel
# above runs the gather route at E=50,001 too)
SPMM_ROUTES = [(2048, 300_000, 256, torch.bfloat16, "tiles"),
               (2048, 300_000, 41, torch.bfloat16, "tiles"),
               (1000, 100_000, 100, torch.bfloat16, "tiles"),
               (2048, 200_000, 602, torch.bfloat16, "tiles"),
               (2048, 65_535, 256, torch.bfloat16, "gather"),
               (2048, 300_000, 256, torch.float32, "gather"),
               (2048, 300_000, 41, torch.float32, "gather")]


@pytest.mark.parametrize("n,e,f,dtype,route", SPMM_ROUTES)
@pytest.mark.parametrize("order", ["sorted", "reversed"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_fused_routes(card, n, e, f, dtype, route, order, weighted):
    g = torch.Generator(device=card).manual_seed(9)
    s = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32)
    r = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32).sort().values
    if order == "reversed":
        s, r = r, s
    w = (torch.rand(e, generator=g, device=card) if weighted
         else torch.ones(e, device=card))
    x = torch.randn(n, f, generator=g, device=card).to(dtype)
    _check_spmm(s, r, w, x, n, route)


@pytest.mark.parametrize("case", ["one_pair_3000", "one_pair_301_ones",
                                  "out_of_range", "empty_receiver_block",
                                  "one_weight_not_one", "ragged_n",
                                  "all_out"])
@pytest.mark.parametrize("f", [41, 256])
def test_spmm_fused_tiles_cases(card, case, f):
    """The tile route on heavy duplicates (one pair 3000 times with a
    weight whose sum bf16 cannot hold; 301 unit weights, counted in
    integers), endpoints out of range, a receiver block with no edges, one
    weight other than 1 among ones (the f32 panel), N not a multiple of 64
    and every endpoint out of range."""
    n, e = 2048, 200_000
    g = torch.Generator(device=card).manual_seed(10)
    s = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32)
    r = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32).sort().values
    w = torch.rand(e, generator=g, device=card)
    if case == "one_pair_3000":
        s[:3000], r[:3000], w[:3000] = 5, 700, 0.3
    elif case == "one_pair_301_ones":
        s[:301], r[:301] = 5, 700
        w = torch.ones(e, device=card)
    elif case == "out_of_range":
        s[::7] = -1
        r[::11] = n
        s[::13] = n + 64
    elif case == "empty_receiver_block":
        r = torch.where((r >= 64) & (r < 128), r + 64, r)
    elif case == "one_weight_not_one":
        w = torch.ones(e, device=card)
        w[e // 2] = 0.5
    elif case == "ragged_n":
        n = 2000
        s, r = s % n, r % n
    elif case == "all_out":
        s[:] = -5
    x = torch.randn(n, f, generator=g, device=card).to(torch.bfloat16)
    if case.startswith("one_pair"):
        x[5] = 1.0
    out = _check_spmm(s, r, w, x, n, "tiles")
    if case == "empty_receiver_block":
        assert not bool(out[64:128].any())
    if case == "all_out":
        assert not bool(out.any())


def test_spmm_fused_without_edges(card):
    """E=0: zeros, no launch."""
    ids = torch.zeros(0, dtype=torch.int32, device=card)
    x = torch.randn(100, 41, device=card).to(torch.bfloat16)
    before = dict(LAUNCHES)
    out = sp._spmm_fused(ids, ids, torch.zeros(0, device=card), x, 100)
    assert dict(LAUNCHES) == before
    assert out.shape == (100, 41) and not bool(out.any())


@pytest.mark.parametrize("f", [41, 256])
def test_spmm_fused_captured_in_a_cuda_graph(card, f):
    """K8's forward and backward (the tile route both ways) captured in a
    CUDA graph without a host read, then replayed on new values written
    into the captured inputs: equal to eager calls within the tolerance."""
    n, e = 2048, 300_000
    g = torch.Generator(device=card).manual_seed(11)
    s = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32)
    r = torch.randint(0, n, (e,), generator=g, device=card,
                      dtype=torch.int32).sort().values
    w = torch.rand(e, generator=g, device=card, requires_grad=True)
    x = torch.randn(n, f, generator=g, device=card).to(
        torch.bfloat16).requires_grad_()
    cot = torch.randn(n, f, generator=g, device=card).to(torch.bfloat16)

    def step():
        out = sp.spmm(s, r, w, x, n, backend="fused")
        return (out,) + torch.autograd.grad(out, (w, x), cot)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            static = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    with torch.no_grad():
        x.copy_(torch.randn(n, f, generator=g, device=card))
        w.copy_(torch.rand(e, generator=g, device=card))
        cot.copy_(torch.randn(n, f, generator=g, device=card))
    before = LAUNCHES["spmm_fused"]
    graph.replay()
    torch.cuda.synchronize()
    assert LAUNCHES["spmm_fused"] == before      # a replay calls no wrapper
    eager = step()
    assert torch.equal(static[1], eager[1])     # dw: the SDDMM, plain torch
    wd, xd = w.detach(), x.detach()
    # out and dx: each within the f32 sums' tolerance and one bf16 rounding
    # (half an ulp) of the plain version's f64 sum; graph and eager sum in
    # other orders, so their bf16 results may differ by a whole ulp
    for ref, abs_sum, pair in (
            (sp.spmm_fused_plain(s, r, wd, xd, n, acc_dtype=F64),
             sp.spmm_fused_plain(s, r, wd, xd.abs(), n, acc_dtype=F64),
             (static[0], eager[0])),
            (sp.spmm_fused_plain(r, s, wd, cot, n, acc_dtype=F64),
             sp.spmm_fused_plain(r, s, wd, cot.abs(), n, acc_dtype=F64),
             (static[2], eager[2]))):
        for got in pair:
            _assert_sums(got, ref, abs_sum, 2 ** -8 * ref.abs())


# spmm(backend="auto") without a backward, at the serving cell's shapes (a
# part of N=2,123, the q=200,000 sampled edges of a draw, the backbone's
# widths): K8's tile route, one launch, no K1, counted on ("spmm",
# "k8_tiles"); under autograd the gather, the multiply and K1.
def _route_delta(run):
    from sgs_gnn_tpu_torch.ops._build import ROUTES
    launches0, routes0 = dict(LAUNCHES), dict(ROUTES)
    out = run()
    torch.cuda.synchronize()
    launches = {k: v - launches0.get(k, 0) for k, v in LAUNCHES.items()
                if v != launches0.get(k, 0)}
    routes = {k: v - routes0.get(k, 0) for k, v in ROUTES.items()
              if v != routes0.get(k, 0)}
    return out, launches, routes


def _sampled_part(card, f, weighted):
    """N=2,123 and q=200,000 receiver-unsorted sampled edges, the last
    2,000 the padding self-loops on node 0 (weight 0 where weighted, as a
    draw's padding selections weigh)."""
    n, q = 2123, 200_000
    g = torch.Generator(device=card).manual_seed(19)
    s, r = _ids(card, g, n, q), _ids(card, g, n, q)
    w = torch.rand(q, generator=g, device=card)
    s[-2000:], r[-2000:], w[-2000:] = 0, 0, 0.0
    x = torch.randn(n, f, generator=g, device=card).to(torch.bfloat16)
    assert sp.spmm_plan(n, f, q, 2).route == "tiles"
    return s, r, (w if weighted else None), x, n


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("f", [256, 41])
def test_forward_only_spmm_takes_k8(card, f, weighted):
    """Held to the f64 plain sum within K8's limit and one bf16 rounding of
    the output, as the fused backend's output is held; the padding
    self-loops count as they come."""
    s, r, w, x, n = _sampled_part(card, f, weighted)
    with torch.no_grad():
        out, launches, routes = _route_delta(
            lambda: sp.spmm(s, r, w, x, n))
    assert launches == {"spmm_fused": 1}
    assert routes == {("spmm", "k8_tiles"): 1, ("spmm_fused", "tiles"): 1}
    assert out.dtype == torch.bfloat16 and out.shape == (n, f)
    wf = torch.ones_like(s, dtype=torch.float32) if w is None else w
    ref = sp.spmm_fused_plain(s, r, wf, x, n, acc_dtype=F64)
    _assert_sums(out, ref, sp.spmm_fused_plain(s, r, wf, x.abs(), n,
                                               acc_dtype=F64),
                 2 ** -8 * ref.abs())


@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_under_autograd_keeps_gather_k1(card, weighted):
    """A call that records a graph keeps the gather, the multiply and K1:
    no K8 launch, counted on ("spmm", "gather_k1")."""
    s, r, w, x, n = _sampled_part(card, 256, weighted)
    x = x.clone().requires_grad_()
    out, launches, routes = _route_delta(lambda: sp.spmm(s, r, w, x, n))
    assert launches == {"scatter_add": 1}
    assert routes[("spmm", "gather_k1")] == 1
    assert ("spmm", "k8_tiles") not in routes
    assert out.requires_grad and out.dtype == torch.bfloat16


def _head(card, g, n, f, k, dtype):
    h = torch.randn(n, f, generator=g, device=card).to(dtype)
    fc1 = torch.randn(2 * f, k, generator=g, device=card) / (2 * f) ** 0.5
    b1 = torch.randn(k, generator=g, device=card) * 0.1
    fc2 = torch.randn(k, 1, generator=g, device=card) / k ** 0.5
    b2 = torch.randn(1, generator=g, device=card) * 0.1
    return h, fc1, b1, fc2, b2


def _ids(card, g, n, q, lo=0, hi=None):
    return torch.randint(lo, n if hi is None else hi, (q,), generator=g,
                         device=card, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f,k,q", [(37, 40, 50, 77), (2048, 256, 256, 4099),
                                     (9, 3, 300, 64), (100, 130, 1, 1),
                                     (2048, 256, 256, 4096 + 37)])
@pytest.mark.parametrize("drop_rate", [0.0, 0.3])
def test_score_head_kernel(card, dtype, n, f, k, q, drop_rate):
    # bf16 runs on the tensor cores (csrc/head_mma.cuh), f32 on CUDA cores
    g = torch.Generator(device=card).manual_seed(2)
    h, fc1, b1, fc2, b2 = _head(card, g, n, f, k, dtype)
    s, r = _ids(card, g, n, q, -1, n + 2), _ids(card, g, n, q, -1, n + 2)
    before = LAUNCHES["score_head_sampled"]
    out = ss.score_head_sampled(h, fc1, b1, fc2, b2, s, r,
                                drop_rate=drop_rate, seed=17)
    torch.cuda.synchronize()
    assert LAUNCHES["score_head_sampled"] == before + 1
    drop = dr.HeadDropout.make(drop_rate, 17, card)
    ref = ss.score_head_plain(h, *ss.split_head(h, fc1, b1, fc2, b2), s, r,
                              drop)
    # same bf16-rounded features and mask on both sides; f32 sums in
    # another order
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    for side in ("senders", "receivers"):
        other = ss.score_head_sampled(h, fc1, b1, fc2, b2, s, r,
                                      drop_rate=drop_rate, seed=17,
                                      sorted_side=side)
        torch.testing.assert_close(other, out, rtol=0, atol=1e-6)


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12)
                 .detach())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f,k,q", [(37, 40, 50, 77), (2048, 256, 256, 5000),
                                     (9, 3, 300, 64), (100, 130, 1, 1),
                                     (300, 260, 20, 1000)])
@pytest.mark.parametrize("side", ["senders", "receivers"])
def test_score_head_bwd_kernel(card, dtype, n, f, k, q, side):
    g = torch.Generator(device=card).manual_seed(3)
    h, fc1, b1, fc2, b2 = _head(card, g, n, f, k, dtype)
    s, r = _ids(card, g, n, q, -1, n + 2), _ids(card, g, n, q, -1, n + 2)
    if side == "senders":
        s = s.sort().values
    else:
        r = r.sort().values
    dp = torch.randn(q, generator=g, device=card)
    params = [t.clone().requires_grad_() for t in (h.float(), fc1, b1, fc2,
                                                    b2)]
    hh = params[0].to(dtype)
    before = LAUNCHES["score_head_bwd"]
    out = ss.score_head_sampled(hh, *params[1:], s, r, drop_rate=0.3,
                                seed=5, sorted_side=side)
    got = torch.autograd.grad(out, params, dp)
    torch.cuda.synchronize()
    assert LAUNCHES["score_head_bwd"] == before + 1
    # the plain backward on the same (swapped) inputs
    w1a, w1b, pb1, w2, pb2 = ss.split_head(hh, fc1, b1, fc2, b2)
    ps, pr = (s, r) if side == "senders" else (r, s)
    if side == "receivers":
        w1b = -w1b
    dh, dw1a, dw1b, db1, dw2, db2 = ss.score_head_bwd_plain(
        hh, w1a, w1b, pb1, w2, pb2, ps, pr, dp,
        dr.HeadDropout.make(0.3, 5, card))
    if side == "receivers":
        dw1b = -dw1b
    want = [dh.to(dtype).float(),
            torch.cat([dw1a.to(dtype), dw1b.to(dtype)]).float(),
            db1, dw2[:, None], db2]
    # f32 sums in another order (atomics): 1e-4 of max|plain|. In bf16 that
    # order can also move a rounding by one bf16 ulp (<= 2^-7 of the value)
    # at a cast before the sums (dz1, dh_u/dh_v) and at the output's cast:
    # per element 2^-6 of |plain| + 1e-3 of max|plain|
    for name, a, b in zip(("dh", "dfc1", "db1", "dfc2", "db2"), got, want):
        err = (a.float() - b).abs()
        if dtype == torch.float32:
            assert _max_rel(a.float(), b) <= 1e-4, (name, _max_rel(a.float(),
                                                                b))
        else:
            tol = 2 ** -6 * b.abs() + 1e-3 * b.abs().max()
            assert bool((err <= tol).all()), (name, _max_rel(a.float(), b))


def test_score_head_bwd_tensor_cores_with_a_hub(card):
    """bf16 K5 takes the tensor-core route (csrc/head_bwd_mma.cuh) and f32
    the CUDA-core one, one launch each; at F=K=256 and q=4,133 (a ragged
    last tile) with 2,500 edges of one sender on the sorted side, whose dh
    row the dh pass merges across 40 blocks of 64 edges."""
    import importlib.util
    from pathlib import Path
    from sgs_gnn_tpu_torch.ops._build import ROUTES
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator(device=card).manual_seed(7)
    n, f, k, q = 2048, 256, 256, 4133
    s = _ids(card, g, n, q, -1, n + 2)
    s[:2500] = 77
    s = s.sort().values
    r = _ids(card, g, n, q, -1, n + 2)
    dp = torch.randn(q, generator=g, device=card)
    drop = dr.HeadDropout.make(0.3, 11, card)

    def dyadic(shape, num, den):
        return torch.randint(-num, num + 1, shape, generator=g,
                             device=card).float() / den

    # dyadic h, W1 and b1: z1's products and sums are exact in f32 in any
    # order, so the kernel and the plain version agree on relu's side for
    # every unit (a z1 within rounding of 0 would otherwise move one unit's
    # term, beyond any bound in the summed |terms| of a node of few edges)
    fc1, b1 = dyadic((2 * f, k), 16, 256), dyadic((k,), 8, 64)
    fc2 = torch.randn(k, 1, generator=g, device=card) / k ** 0.5
    b2 = torch.randn(1, generator=g, device=card) * 0.1
    h8 = dyadic((n, f), 8, 8)
    for dtype, route in ((torch.bfloat16, "tensor_cores"),
                         (torch.float32, "cuda_cores")):
        h = h8.to(dtype)
        split = ss.split_head(h, fc1, b1, fc2, b2)
        before = dict(ROUTES)
        got = ss._head_bwd(h, *split, s, r, dp, drop)
        torch.cuda.synchronize()
        after = dict(ROUTES)
        assert after.pop(("score_head_bwd", route)) == \
            before.pop(("score_head_bwd", route), 0) + 1
        assert after == before
        want = ss.score_head_bwd_plain(h, *split, s, r, dp, drop)
        terms = smoke._head_bwd_abs_sums(torch, ss, h, *split, s, r, dp, drop)
        # dlogit's f32 sums in another order move the value before a bf16
        # cast (dz1, dh_u / dh_v) across a rounding boundary for rare
        # terms, one bf16 ulp (<= 2^-7 of the term) apart: per element 2^-7
        # of the summed |terms| + 1e-6 (most nodes here have 2-4 edges, so
        # one such term can exceed chip_smoke.py's 2^-9 at q=200k); the
        # hub's row sums 2,500 edges: 2^-9 of them
        for name, a, b, c in zip(("dh", "dW1a", "dW1b", "db1", "dw2", "db2"),
                                 got, want, terms):
            ratio = (a - b).abs() / (2 ** -7 * c + 1e-6)
            assert float(ratio.max()) <= 1.0, (
                dtype, name, float(ratio.max()), int((ratio > 1).sum()),
                [int(i) for i in torch.nonzero(ratio > 1)[:4].flatten()])
        hub = (got[0][77] - want[0][77]).abs()
        assert bool((hub <= 2 ** -9 * terms[0][77] + 1e-6).all()), (
            dtype, float((hub / terms[0][77]).max()))
        assert float(got[0][77].abs().sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,b,f,k", [(50, 16, 32, 24, 40),
                                       (2048, 128, 512, 256, 256),
                                       (130, 64, 64, 33, 7),
                                       (3000, 128, 512, 256, 300)])
def test_score_tiles_kernel(card, dtype, n, t, b, f, k):
    import numpy as np
    rng = np.random.default_rng(4)
    e = 40 * n
    ti = st.build_tile_index(rng.integers(0, n, e), rng.integers(0, n, e), n,
                             t=t, b=b, max_overhead=100.0)
    assert not ti.valid.all()                       # padding slots present
    tl = [torch.from_numpy(a).to(card) for a in (ti.ls, ti.lr, ti.su, ti.rv)]
    g = torch.Generator(device=card).manual_seed(4)
    h, fc1, b1, fc2, b2 = _head(card, g, n, f, k, dtype)
    before = LAUNCHES["score_head_tiles"]
    out = st.score_head_tiles(h, fc1, b1, fc2, b2, *tl, t=t, bk=b,
                              drop_rate=0.3, seed=9)
    torch.cuda.synchronize()
    assert LAUNCHES["score_head_tiles"] == before + 1
    assert not out.requires_grad
    ref = st.score_head_tiles_plain(h, *ss.split_head(h, fc1, b1, fc2, b2),
                                    *tl, t, b,
                                    dr.HeadDropout.make(0.3, 9, card))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_head_routes_count_one_launch_each(card):
    """bf16 (tensor cores) and f32 (CUDA cores) each launch once under the
    forward's own name: K3, K3 with a sorted side, K6."""
    import numpy as np
    n, f, k, q = 300, 64, 256, 1000
    rng = np.random.default_rng(10)
    ti = st.build_tile_index(rng.integers(0, n, q), rng.integers(0, n, q), n,
                             t=64, b=128, max_overhead=100.0)
    tl = [torch.from_numpy(a).to(card) for a in (ti.ls, ti.lr, ti.su, ti.rv)]
    g = torch.Generator(device=card).manual_seed(10)
    s, r = _ids(card, g, n, q).sort().values, _ids(card, g, n, q)
    for dtype in (torch.bfloat16, torch.float32):
        h, fc1, b1, fc2, b2 = _head(card, g, n, f, k, dtype)
        for name, run in (
                ("score_head_sampled", lambda: ss.score_head_sampled(
                    h, fc1, b1, fc2, b2, s, r)),
                ("score_head_sampled_banded", lambda: ss.score_head_sampled(
                    h, fc1, b1, fc2, b2, s, r, sorted_side="senders")),
                ("score_head_tiles", lambda: st.score_head_tiles(
                    h, fc1, b1, fc2, b2, *tl, t=64, bk=128))):
            before = dict(LAUNCHES)
            run()
            torch.cuda.synchronize()
            after = dict(LAUNCHES)
            assert after.pop(name) == before.pop(name, 0) + 1, (dtype, name)
            assert after == before, (dtype, name)


def test_hash32_table_on_card(card):
    for seed, counter, want in HASH32_TABLE:
        got = dr.hash32(torch.tensor([seed], device=card, dtype=torch.int32),
                        torch.tensor([counter], device=card))
        assert int(got[0]) == want, (seed, counter)
    ctr = torch.arange(0, 1 << 20, 7919, device=card)
    seed = torch.tensor([123456], device=card, dtype=torch.int32)
    assert torch.equal(dr.hash32(seed, ctr).cpu(),
                       dr.hash32_plain(123456, ctr.cpu()))


def test_segment_sum_autograd_on_card(card):
    g = torch.Generator(device=card).manual_seed(6)
    n, e, f = 300, 5000, 70
    x = torch.randn(n, f, generator=g, device=card, requires_grad=True)
    w = torch.rand(e, generator=g, device=card, requires_grad=True)
    ids = _ids(card, g, n, e)
    cot = torch.randn(n, f, generator=g, device=card)
    rows = eg.gather_rows(x, ids)
    deg = sc.segment_sum_scalar(w, ids, n)
    before = LAUNCHES["scatter_add"]
    dx, = torch.autograd.grad(rows, x, torch.randn_like(rows))
    assert LAUNCHES["scatter_add"] == before + 1     # gather_rows' VJP is K1
    dw, = torch.autograd.grad(deg, w, cot[:, 0])
    assert torch.equal(dw, cot[:, 0][ids.long()])
    vals = torch.randn(e, f, generator=g, device=card, requires_grad=True)
    dv, = torch.autograd.grad(sc.scatter_add(vals, ids, n), vals, cot)
    assert torch.equal(dv, cot[ids.long()])
    assert dx.shape == x.shape


# K1's and K2's VJP on the card (ops/scatter.py rows_at_cast,
# csrc/rows_at.cu): bit for bit the plain rows_at(g, ids, n).to(dtype) it
# replaced. The cells' shapes (E = 200,000 sampled ids of a part of N =
# 2,123: GCN's bf16 messages at F = 256 and 41, GAT's and GIN's f32 ones,
# K2's (N,) cotangent), then the CPU test's cases: narrow and odd widths,
# E = 0.
ROWS_AT_CASES = [(2123, 200_000, 256, torch.bfloat16),
                 (2123, 200_000, 41, torch.bfloat16),
                 (2123, 200_000, 256, torch.float32),
                 (2123, 200_000, 41, torch.float32),
                 (2123, 200_000, None, torch.float32),
                 (37, 1001, 1, torch.bfloat16),
                 (37, 1001, 8, torch.bfloat16),
                 (37, 1001, 4, torch.float32),
                 (5, 333, 300, torch.float32),
                 (37, 0, 256, torch.bfloat16),
                 (37, 0, None, torch.float32)]
BAD_IDS = (-1, -(2 ** 31), 2 ** 31 - 1)


def _rows_at_inputs(card, n, e, f, seed):
    """A cotangent (n, f) (or (n,) for f None) and int32 ids in [0, n) with
    -1, n, 2**31 - 1 and -2**31 among them."""
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (n,) if f is None else (n, f)
    g = torch.randn(shape, generator=gen, device=card)
    ids = _ids(card, gen, n, e)
    for j, bad in enumerate(BAD_IDS + (n,)):
        ids[j * 7 % max(e, 1):][:1] = bad
    return g, ids


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _launched(run):
    before = dict(LAUNCHES)
    out = run()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("n,e,f,dtype", ROWS_AT_CASES)
def test_rows_at_kernel_is_the_plain_chain_bit_for_bit(card, n, e, f,
                                                       dtype):
    g, ids = _rows_at_inputs(card, n, e, f, seed=n + e)
    out, launched = _launched(lambda: sc.rows_at_cast(g, ids, n, dtype))
    ref = sc.rows_at(g, ids, n).to(dtype)
    assert launched == ({"rows_at": 1} if e else {})
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(_bits(out), _bits(ref))
    # the K1 and K2 wrappers: their backward is this launch
    vals = torch.zeros(ids.shape + g.shape[1:], dtype=dtype, device=card,
                       requires_grad=True)
    fwd = sc.scatter_add if f is not None else sc.segment_sum_scalar
    y = fwd(vals, ids, n)
    (dv,), launched = _launched(lambda: torch.autograd.grad(y, vals, g))
    assert launched == ({"rows_at": 1} if e else {})
    assert dv.dtype == dtype and torch.equal(_bits(dv), _bits(ref))


@pytest.mark.parametrize("how", ["strided", "expanded", "misaligned"])
def test_rows_at_kernel_odd_cotangents(card, how):
    """A cotangent autograd may hand over: strided, expanded, or a view 4
    bytes off 16-byte alignment (the element route)."""
    n, e, f = 300, 5000, 64
    _, ids = _rows_at_inputs(card, n, e, f, seed=5)
    if how == "strided":
        g = torch.randn(f, n, device=card).t()
    elif how == "expanded":
        g = torch.randn(1, f, device=card).expand(n, f)
    else:
        g = torch.randn(n * f + 1, device=card)[1:].view(n, f)
        assert g.data_ptr() % 16 != 0
    bf16 = torch.bfloat16
    out, launched = _launched(lambda: sc.rows_at_cast(g, ids, n, bf16))
    assert launched == {"rows_at": 1}
    assert torch.equal(_bits(out), _bits(sc.rows_at(g, ids, n).to(bf16)))


def test_rows_at_kernel_in_a_cuda_graph(card):
    n, e, f = 2123, 200_000, 256
    g, ids = _rows_at_inputs(card, n, e, f, seed=8)
    static_g = g.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sc.rows_at_cast(static_g, ids, n, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sc.rows_at_cast(static_g, ids, n, torch.bfloat16)
    for seed in (1, 2):
        static_g.copy_(torch.randn(n, f, device=card,
                                   generator=torch.Generator(
                                       device=card).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        ref = sc.rows_at(static_g, ids, n).to(torch.bfloat16)
        assert torch.equal(_bits(out), _bits(ref))


def test_k1_backward_launches_one_kernel_under_the_profiler(card):
    """K1's backward on the card: one kernel, rows_at_kernel; no where,
    index or gather of the library."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, e, f = 2123, 200_000, 256
    g, ids = _rows_at_inputs(card, n, e, f, seed=3)
    vals = torch.zeros(e, f, dtype=torch.bfloat16, device=card,
                       requires_grad=True)
    y = sc.scatter_add(vals, ids, n)
    torch.autograd.grad(y, vals, g, retain_graph=True)     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y, vals, g)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "rows_at_kernel" in names[0], names


def test_rows_at_launches_are_the_backward_calls_of_a_graphed_step(
        card, monkeypatch):
    """LAUNCHES["rows_at"] over a graphed GCN learned epoch: one launch
    per K1 and K2 backward, in the eager first calls and in each graph's
    tally (which every replay adds)."""
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    calls = collections.Counter()
    for cls in (sc._ScatterAdd, sc._SegmentSumScalar):
        def backward(ctx, g, _orig=cls.backward):
            calls["capture" if torch.cuda.is_current_stream_capturing()
                  else "eager"] += 1
            return _orig(ctx, g)
        monkeypatch.setattr(cls, "backward", staticmethod(backward))
    cfg = Config(**GRAPHED_BASE, **GRAPHED_KW["hybrid_rescore"])
    batches, plan, q, classes = _graphed_batches(card, cfg)
    tm, opt = _graphed_model(card, cfg, batches, classes)
    steps = make_scan_epoch_step(cfg, tm, opt, q, 4, len(batches))
    LAUNCHES.clear()
    _run_epochs(steps, batches, plan, 2, torch.Generator(device=card))
    torch.cuda.synchronize()
    caps = list(steps.graphs.by_key.values())
    assert sum(c.replays for c in caps) > 0
    assert sum(c.launches["rows_at"] for c in caps) == calls["capture"] > 0
    replayed = sum(c.launches["rows_at"] * c.replays for c in caps)
    assert LAUNCHES["rows_at"] - replayed == calls["eager"] > 0


def test_gather_rows_sorted_band_on_card(card):
    g = torch.Generator(device=card).manual_seed(9)
    n, e, f = 300, 40_000, 64
    x = torch.randn(n, f, generator=g, device=card).to(torch.bfloat16) \
        .requires_grad_()
    ids = _ids(card, g, n, e).sort().values
    band = sc.required_band(ids.cpu().numpy())
    cot = torch.randn(e, f, generator=g, device=card).to(torch.bfloat16)
    before = dict(LAUNCHES)
    dx, = torch.autograd.grad(eg.gather_rows(x, ids, band), x, cot)
    assert LAUNCHES["scatter_add_sorted"] == \
        before.get("scatter_add_sorted", 0) + 1
    assert LAUNCHES["scatter_add"] == before.get("scatter_add", 0)
    ref = sc.scatter_add_plain(cot, ids, n, acc_dtype=F64)
    # one rounding to bf16 of the f32 sums
    _assert_sums(dx, ref, sc.scatter_add_plain(cot.abs(), ids, n,
                                               acc_dtype=F64),
                 2 ** -8 * ref.abs())


def test_kernels_raise_on_bad_input(card):
    v = torch.zeros(4, 3, device=card)
    with pytest.raises(TypeError):
        sc.scatter_add(v, torch.zeros(4, dtype=torch.int64, device=card), 2)
    with pytest.raises(TypeError):
        sc.scatter_add(v.half(), torch.zeros(4, dtype=torch.int32,
                                             device=card), 2)
    h = torch.zeros(4, 3, device=card)
    ids = torch.zeros(2, dtype=torch.int32, device=card)
    head = (torch.zeros(6, 5, device=card), torch.zeros(5, device=card),
            torch.zeros(5, 1, device=card), torch.zeros(1, device=card))
    with pytest.raises(ValueError):
        ss.score_head_sampled(h, *head, ids, ids, drop_rate=1.0)
    with pytest.raises(TypeError):
        ss.score_head_sampled(h, *head, ids.long(), ids.long())
    with pytest.raises(ValueError):
        ss.score_head_sampled(h, *head, ids, ids, sorted_side="both")
    with pytest.raises(ValueError):
        ss.score_head_sampled(h, *head, ids.cpu(), ids.cpu())  # two devices
    with pytest.raises(TypeError):
        sc.scatter_add_sorted(v, torch.zeros(4, dtype=torch.int64,
                                             device=card), 2, 8)
    with pytest.raises(TypeError):
        sp.spmm(ids, ids, None, h.half(), 4, backend="fused")
    with pytest.raises(ValueError):
        sp.spmm(ids, ids, None, h, 5, backend="fused")   # N != x rows


# ------------------------------------------------- experiments on the card


def _padded_partitions(card):
    """Two partitions of a community graph padded to one shape class: the
    small one gets ~0.9M padding edges, self-loops on the ghost node."""
    from sgs_gnn_tpu_torch.data import (community_sbm_graph, partition,
                                        to_undirected)
    x, ei, y, (tr, va, te) = community_sbm_graph(
        n=4000, num_classes=8, communities=2, deg=300, feat_dim=16, seed=1)
    ei = to_undirected(ei)
    part = (torch.arange(4000) >= 3200).to(torch.int32).numpy()
    return partition.induced_subgraphs(x, ei, y, tr, va, te, part, 2,
                                       shape_classes=1, device=card)


def test_row_kernels_on_a_padded_partition(card):
    """K1 and K2 on a padded partition's edge list: the receivers end in
    one run of ~0.9M ghost-node ids (far beyond the 10,000 consecutive
    padding ids of test_scatter_add_padding_ids)."""
    batches = _padded_partitions(card)
    g = min(batches, key=lambda b: int(b.edge_mask.sum()))
    ghost = g.num_nodes - 1
    pad = g.num_edges - int(g.edge_mask.sum())
    assert pad > 500_000 and int((g.receivers == ghost).sum()) >= pad
    gen = torch.Generator(device=card).manual_seed(3)
    for ids in (g.receivers, g.senders):
        for f in (256, 41):
            vals = torch.randn(g.num_edges, f, generator=gen,
                               device=card).to(torch.bfloat16)
            _check_scatter(vals, ids, g.num_nodes)
    w = torch.rand(g.num_edges, generator=gen, device=card)
    out = sc.segment_sum_scalar(w, g.receivers, g.num_nodes)
    # the plain version's sums in f64: in f32, index_add_'s atomics add the
    # ghost's ~0.9M weights one by one in an order that changes per call,
    # and on an H100 (tools/graphed_readings.py k2_ghost) its sum (~5.3e5)
    # strayed from the f64 one by up to 9.4, beyond the limit (5.3) in 12
    # of 40 calls, while the kernel's stayed within 0.18
    ref = sc.segment_sum_scalar_plain(w, g.receivers, g.num_nodes,
                                      acc_dtype=F64)
    _assert_sums(out, ref, ref)


def test_learned_run_experiment_on_card(card, tmp_path):
    """Two epochs of the learned hybrid_rescore experiment on 3 native
    partitions in bf16: finite losses, F1s in [0, 1], the tile index built
    ('auto' on the card) and every kernel of the path launched (K1-K6)."""
    from sgs_gnn_tpu_torch.data import (HostDataset, community_sbm_graph,
                                        degree_prior, edge_homophily,
                                        to_undirected)
    from sgs_gnn_tpu_torch.run import cli, driver
    x, ei, y, (tr, va, te) = community_sbm_graph(
        n=3000, num_classes=8, communities=3, deg=100, feat_dim=64, seed=0)
    ei = to_undirected(ei)
    ds = HostDataset("community", x, ei, y, tr, va, te,
                     degree_prior(ei[0], ei[1], 3000), 8,
                     edge_homophily(ei, y))
    cfg = cli.config_from_args([
        "--mode", "learned", "--pipeline", "hybrid", "--sparse_edge_mlp",
        "true", "--dtype", "bfloat16", "--nhid", "128", "--epochs", "2",
        "--metis_threshold", str(ds.num_edges // 3 + 1), "--stats", "true",
        "--log", "true", "--num_samples_eval", "3", "--results_dir",
        str(tmp_path)])
    lines = []
    LAUNCHES.clear()
    (res,) = driver.run_experiment(cfg, ds, log_fn=lines.append)
    torch.cuda.synchronize()
    assert res.plan["partitioner"] == "native" and res.plan["parts"] == 3
    assert all(torch.isfinite(torch.tensor(res.losses)))
    for f in res.train_curve + res.val_curve + res.test_curve + [
            res.final_train_f1, res.final_val_f1, res.final_test_f1]:
        assert 0.0 <= f <= 1.0
    assert any("tile_score_kernel=on" in ln for ln in lines), lines
    for k in ("scatter_add", "segment_sum_scalar", "score_head_sampled",
              "score_head_sampled_banded", "score_head_bwd",
              "score_head_tiles"):
        assert LAUNCHES[k] > 0, (k, dict(LAUNCHES))
    assert res.peak_device_mem_mb > 0
    assert (tmp_path / "community" / "0.2.csv").exists()
    # scan_epoch=auto on the card: the graphed epoch and eval ran
    assert res.epoch_route == "graphed"
    assert res.graphs["train_replays"] > 0 and res.graphs["eval_replays"] > 0
    assert any(ln.startswith("[fastpath] epoch=graphed") for ln in lines)


# ------------------------------------- the other layers (GIN, GAT, Cheb)
#
# Each layer on the card against the same layer and weights on the CPU in
# f32 (plain versions), forward and backward, relative L2 per tensor. In
# f32 the card differs only by the order of f32 sums (K1, K2 atomics):
# 1e-5 on outputs, 1e-4 on gradients. In bf16 it also rounds the input,
# the weights and the projection to 8 significant bits (2^-9 relative
# each), as the same layer on the CPU in bf16 does: the limit is the larger
# of chip_smoke.py's grad_check limits (2% on outputs, 5% on gradients) and
# twice the CPU bf16 run's own error. The second term matters for GAT's
# attention vectors, whose gradients sum terms that cancel over each
# node's edges (the softmax Jacobian), so the rounding comes back
# amplified (att_dst: 3-5% on the CPU at this size).
LAYER_CASES = ["sage", "gin", "gat_h1_mean", "gat_h2_concat", "cheb_k1",
               "cheb_k3"]


def _layer(case, f_in, f_out, dtype):
    from sgs_gnn_tpu_torch.models import layers as ly
    gen = torch.Generator().manual_seed(3)
    return {
        "sage": lambda: ly.SAGEConv(f_in, f_out, dtype, gen),
        "gin": lambda: ly.GINConv(f_in, 48, f_out, dtype, gen),
        "gat_h1_mean": lambda: ly.GATConv(f_in, f_out, 1, False,
                                          dtype=dtype, generator=gen),
        "gat_h2_concat": lambda: ly.GATConv(f_in, f_out, 2, True,
                                            dtype=dtype, generator=gen),
        "cheb_k1": lambda: ly.ChebConv(f_in, f_out, 1, dtype=dtype,
                                       generator=gen),
        "cheb_k3": lambda: ly.ChebConv(f_in, f_out, 3, dtype=dtype,
                                       generator=gen),
    }[case]()


def _rel_l2(a, b):
    return float((a.float().cpu() - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_on_card_matches_cpu_f32(card, case, dtype):
    rng = np.random.default_rng(7)
    n, e, f_in, f_out = 600, 30_000, 64, 32
    x = torch.from_numpy(rng.normal(size=(n, f_in)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, n - 1, e).astype(np.int32))  # n-1:
    w = torch.from_numpy(rng.uniform(0.1, 1.0, e).astype(np.float32))  # empty
    out, grads, launched, cot = {}, {}, {}, None
    runs = [("card", card, dtype), ("cpu", "cpu", torch.float32)]
    if dtype == torch.bfloat16:
        runs.append(("cpu_bf16", "cpu", dtype))
    for side, dev, dt in runs:
        layer = _layer(case, f_in, f_out, dt).to(dev)
        xd = x.to(dev).requires_grad_()
        LAUNCHES.clear()
        y = layer(xd, s.to(dev), r.to(dev), w.to(dev))
        if cot is None:
            cot = torch.from_numpy(rng.normal(size=tuple(y.shape))
                                   .astype(np.float32))
        names, params = zip(*layer.named_parameters())
        g = torch.autograd.grad(y, list(params) + [xd], cot.to(dev))
        out[side] = y.detach().float().cpu()
        grads[side] = dict(zip(list(names) + ["x"], g))
        launched[side] = dict(LAUNCHES)
    # K=1 Chebyshev is graph-free; every other layer sums on the kernels
    assert bool(launched["card"]) == (case != "cheb_k1"), launched
    assert not launched["cpu"]
    if dtype == torch.float32:
        val_tol, grad_tol = 1e-5, dict.fromkeys(grads["cpu"], 1e-4)
    else:
        val_tol = max(2e-2, 2 * _rel_l2(out["cpu_bf16"], out["cpu"]))
        grad_tol = {k: max(5e-2, 2 * _rel_l2(grads["cpu_bf16"][k], want))
                    for k, want in grads["cpu"].items()}
    assert _rel_l2(out["card"], out["cpu"]) <= val_tol
    for name, want in grads["cpu"].items():
        assert _rel_l2(grads["card"][name], want) <= grad_tol[name], name


# ------------------------------------------------------ the graphed epoch
#
# A graphed epoch and an eager one from the same seeds draw the same
# samples and masks, so they differ only where atomics add f32 terms in
# another order (K1, K2, K5). On an H100 (tools/graphed_readings.py
# noise) that noise, after 3 epochs of this setup, left each parameter
# tensor within a relative L2 distance of 7.7e-8 of the eager run's (two
# eager runs: 7.6e-8) and the summed losses within a relative 9.6e-8
# (two eager runs: 8.1e-8), in every mode. The limits leave more than 10x
# of that: parameters within a relative L2 distance of 1e-6 per tensor,
# losses within rtol 2e-6; the launches exactly.
PARAM_REL_L2 = 1e-6
LOSS_RTOL = 2e-6

GRAPHED_KW = {
    "hybrid_rescore": dict(mode="learned", pipeline="hybrid",
                           conditional=True, sparse_edge_mlp=True, reg1=True,
                           reg2=True),
    # the GAT backbone with the GraphSAGE scorer (segment softmax, K2 on
    # the attention terms, K1 on f32 messages and raw features)
    "hybrid_rescore_gat_gsage": dict(
        mode="learned", pipeline="hybrid", conditional=True,
        sparse_edge_mlp=True, reg1=True, reg2=True, GNN="GAT",
        edge_mlp_type="GSAGE"),
    "two_pass": dict(mode="learned", pipeline="two_pass", conditional=True,
                     sparse_edge_mlp=True, reg1=True, reg2=True),
    # the dense-subgraph route under capture: (N, N) builds and products
    # from the class's pool
    "hybrid_rescore_dense": dict(mode="learned", pipeline="hybrid",
                                 conditional=True, sparse_edge_mlp=True,
                                 reg1=True, reg2=True, dense_subgraph="on"),
    "random": dict(mode="random"),
    "full": dict(mode="full"),
}
GRAPHED_BASE = dict(shape_classes=2, nhid=32, runs=1, num_samples_eval=3)


def _graphed_batches(card, cfg):
    """4 native partitions of a 4-community graph (~190k edges) in 2 shape
    classes on the card, with the tile index (tiles accepted) for
    hybrid_rescore, and a plan of a sampled batch in each class, a small
    and a skipped one; q below the sampled batches' valid edges."""
    from sgs_gnn_tpu_torch.data import (HostDataset, community_sbm_graph,
                                        degree_prior, edge_homophily,
                                        to_undirected)
    from sgs_gnn_tpu_torch.run import driver
    n = 2000
    x, ei, y, (tr, va, te) = community_sbm_graph(
        n=n, num_classes=5, communities=4, deg=60, feat_dim=32, seed=0)
    ei = to_undirected(ei)
    ds = HostDataset("community4", x, ei, y, tr, va, te,
                     degree_prior(ei[0], ei[1], n), 5, edge_homophily(ei, y))
    cfg = cfg.replace(metis_threshold=ds.num_edges // 4 + 1)
    batches, _, _ = driver.prepare_batches(cfg, ds, card)
    shapes = [g.num_edges for g in batches]
    alone = [i for i, e in enumerate(shapes) if shapes.count(e) == 1]
    assert len(batches) == 4 and len(alone) == 1, shapes
    others = [i for i in range(4) if i != alone[0]]
    plan = [0] * 4
    plan[alone[0]], plan[others[0]], plan[others[1]] = 2, 1, 2
    valid = [int(g.edge_mask.sum()) for g in batches]
    q = min(v for v, a in zip(valid, plan) if a == 2) // 3
    return batches, plan, q, ds.num_classes


def _graphed_model(card, cfg, batches, classes):
    from sgs_gnn_tpu_torch import DualOptimizer, get_model
    tm = get_model(cfg.GNN, batches[0].x.shape[1], cfg.nhid, classes,
                   cfg.drop_rate, cfg.edge_mlp_type, heads=cfg.gat_heads,
                   device=card, generator=torch.Generator().manual_seed(1))
    return tm, DualOptimizer.create(tm, cfg.GNN, cfg.lr, cfg.weight_decay)


def _run_epochs(steps, batches, plan, epochs, gen, first=0):
    from sgs_gnn_tpu_torch.run import driver
    sums = []
    for epoch in range(first, first + epochs):
        order = [(epoch + i) % len(batches) for i in range(len(batches))]
        acc = steps(batches, order, plan, epoch, gen,
                    lambda n: driver.batch_seed(0, 0, n))
        sums.append([float(v) for v in acc])
    return sums


def _close_rel(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        dist = float((a - b).norm())
        assert dist <= PARAM_REL_L2 * float(b.norm()), (what, i, dist)


@pytest.mark.parametrize("name", list(GRAPHED_KW))
def test_graphed_epoch_equals_the_eager_epoch(card, name):
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    cfg = Config(**GRAPHED_BASE, **GRAPHED_KW[name])
    batches, plan, q, classes = _graphed_batches(card, cfg)
    if name.startswith("hybrid_rescore"):
        assert batches[0].tile_t > 0          # K6 scores the tile slots
    out = {}
    for route in ("eager", "graphed"):
        tm, opt = _graphed_model(card, cfg, batches, classes)
        steps = make_scan_epoch_step(cfg, tm, opt, q, 4, len(batches),
                                     loop=route == "eager")
        LAUNCHES.clear()
        sums = _run_epochs(steps, batches, plan, 3,
                           torch.Generator(device=card))
        torch.cuda.synchronize()
        out[route] = (sums, [p.detach().clone() for p in tm.parameters()],
                      dict(LAUNCHES), steps)
    (s_e, p_e, l_e, _), (s_g, p_g, l_g, graphed) = out["eager"], \
        out["graphed"]
    assert len(graphed.graphs) == 3          # small x1, sampled x2 classes
    assert graphed.graphs.replays == 3 * 3 - 3      # from epoch 1 on
    assert l_g == l_e and l_g                  # the tallies: eager's counts
    for (le, ce, te), (lg, cg, tg) in zip(s_e, s_g):
        assert lg == pytest.approx(le, rel=LOSS_RTOL)
        assert tg == pytest.approx(te) and 0 <= cg <= 2
    moved = any(not torch.equal(a, b) for a, b in zip(
        p_g, [p.detach() for p in _graphed_model(card, cfg, batches,
                                                 classes)[0].parameters()]))
    assert moved
    _close_rel(p_g, p_e, name)


def test_graphed_eval_equals_the_eager_eval(card):
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.eval import make_scan_eval_step
    for mode in ("learned", "random", "full"):
        cfg = Config(**GRAPHED_BASE, mode=mode, pipeline="hybrid")
        batches, _, q, classes = _graphed_batches(card, cfg)
        tm, _ = _graphed_model(card, cfg, batches, classes)
        small = [1, 0, 1, 0]
        eager = make_scan_eval_step(cfg, tm, q, loop=True)
        scan = make_scan_eval_step(cfg, tm, q)
        gen = torch.Generator(device=card)
        LAUNCHES.clear()
        want = [eager(batches, small, gen, s) for s in (5, 6, 5)]
        launches = dict(LAUNCHES)
        LAUNCHES.clear()
        got = [scan(batches, small, gen, s) for s in (5, 6, 5)]
        assert dict(LAUNCHES) == launches
        keys = {(g.num_edges, f) for g, f in zip(batches, small)}
        assert len(scan.graphs) == len(keys)
        assert scan.graphs.replays == 3 * 4 - len(keys)
        for w, g_ in zip(want, got):
            for k in w:
                # a count is exact; a weighted F1 may differ by a node
                # whose logits tie within f32 reordering
                tol = 0.0 if k.endswith("count") else 2.0
                assert abs(float(g_[k]) - float(w[k])) <= tol, (mode, k)


def _serve_model(card, dtype="float32"):
    from sgs_gnn_tpu_torch import Config, Graph, get_model
    from sgs_gnn_tpu_torch.data import degree_prior
    rng = np.random.default_rng(0)
    n, e, f, c = 300, 20_000, 24, 5
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    g = Graph.build(rng.normal(size=(n, f)).astype(np.float32), ei,
                    rng.integers(0, c, n).astype(np.int32),
                    prob=degree_prior(ei[0], ei[1], n), num_classes=c,
                    sort_by_receiver=True, device=card)
    cfg = Config(nhid=32, num_samples_eval=4, dtype=dtype)
    tm = get_model("GCN", f, cfg.nhid, c, cfg.drop_rate, "GCN",
                   dtype=cfg.dtype, device=card,
                   generator=torch.Generator().manual_seed(0))
    return cfg, g, tm, 4_000


def test_predict_on_k8_matches_the_gather_k1_route(card, monkeypatch):
    """bf16 ``predict`` (graphed) aggregates every GCN layer with K8 (the
    encoder over 20,000 edges and each draw's 4,000 on 25 tiles): counted
    on ("spmm", "k8_tiles") alone, and its logits within the serving
    cell's ``logit_gap`` limit of the same call, eager, with every
    aggregation forced onto the gather, the multiply and K1."""
    import json
    from pathlib import Path
    from sgs_gnn_tpu_torch import make_predictor
    from sgs_gnn_tpu_torch.ops._build import ROUTES
    limit = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                        / "limits" / "gcn_reddit.serve_predict.json")
                       .read_text())["logit_gap"]
    cfg, g, tm, q = _serve_model(card, "bfloat16")
    predict = make_predictor(cfg, tm, q)
    layers = 2 + 2 * cfg.num_samples_eval
    for seed in (1, 2):                 # eager + capture, then a replay
        before = collections.Counter(ROUTES)
        logits, _ = predict(g, torch.Generator(device=card).manual_seed(seed))
        torch.cuda.synchronize()
        assert {k: v for k, v in (ROUTES - before).items()
                if k[0] == "spmm"} == {("spmm", "k8_tiles"): layers}
    with monkeypatch.context() as m:
        m.setattr(sp, "auto_route", lambda *a: "gather_k1")
        before = collections.Counter(ROUTES)
        want, _ = predict.eager(g, torch.Generator(device=card).manual_seed(2))
        assert {k: v for k, v in (ROUTES - before).items()
                if k[0] in ("spmm", "spmm_fused")} == {
            ("spmm", "gather_k1"): layers}
    gap = float((logits.float() - want.float()).abs().max())
    assert gap <= limit, gap


@pytest.mark.parametrize("new_generator", [False, True],
                         ids=["one_generator", "generator_per_call"])
def test_graphed_predict_equals_eager_predict(card, new_generator):
    """One generator for every call, or a new one per call as a server
    that makes one per request: either way one graph per shape, replayed
    from the second call on, with the eager call's draws and generator
    state."""
    from sgs_gnn_tpu_torch import make_predictor, make_sparsifier
    cfg, g, tm, q = _serve_model(card)
    for make in (make_sparsifier, make_predictor):
        graphed = make(cfg, tm, q)
        eager = graphed.eager
        gen_g = torch.Generator(device=card)
        gen_e = torch.Generator(device=card)
        for seed in (1, 2, 1):            # eager + capture, then replays
            if new_generator:
                gen_g = torch.Generator(device=card)
            LAUNCHES.clear()
            out_e = eager(g, gen_e.manual_seed(seed))
            launches = dict(LAUNCHES)
            LAUNCHES.clear()
            out_g = graphed(g, gen_g.manual_seed(seed))
            assert dict(LAUNCHES) == launches
            # the generator advanced as the eager call advanced it
            assert torch.equal(gen_g.get_state(), gen_e.get_state())
            for a, b in zip(out_g, out_e):
                if a.dtype.is_floating_point:
                    tol = 1e-5 * max(float(b.abs().max()), 1.0)
                    assert float((a - b).abs().max()) <= tol
                elif make is make_sparsifier:
                    assert torch.equal(a, b)       # the same draw
        assert len(graphed.graphs) == 1 and graphed.graphs.replays == 2


def test_graphed_draws_follow_the_reseed(card):
    """Two batch ids give two samples; the same id the same sample."""
    from sgs_gnn_tpu_torch import make_sparsifier
    from sgs_gnn_tpu_torch.run.driver import batch_seed
    cfg, g, tm, q = _serve_model(card)
    sparsify = make_sparsifier(cfg, tm, q)
    gen = torch.Generator(device=card)
    ids = {}
    for n in (1, 2, 1, 2):
        out = sparsify(g, gen.manual_seed(batch_seed(0, 0, n)))
        ids.setdefault(n, []).append(torch.sort(out.edge_ids).values)
    assert sparsify.graphs.replays == 3
    assert torch.equal(ids[1][0], ids[1][1])
    assert torch.equal(ids[2][0], ids[2][1])
    assert not torch.equal(ids[1][0], ids[2][0])


def test_resumed_state_replays_into_graphs_captured_before(card):
    """Load a saved model and optimizer state into a run whose graphs are
    already captured: the next epoch replays those graphs (no capture) and
    repeats the epoch that followed the save."""
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    cfg = Config(**GRAPHED_BASE, **GRAPHED_KW["hybrid_rescore"])
    batches, plan, q, classes = _graphed_batches(card, cfg)
    tm, opt = _graphed_model(card, cfg, batches, classes)
    steps = make_scan_epoch_step(cfg, tm, opt, q, 4, len(batches))
    gen = torch.Generator(device=card)
    _run_epochs(steps, batches, plan, 1, gen)
    saved = ({k: v.clone() for k, v in tm.state_dict().items()},
             {grp: {"count": st["count"].clone(),
                    "mu": [None if t is None else t.clone()
                           for t in st["mu"]],
                    "nu": [None if t is None else t.clone()
                           for t in st["nu"]]}
              for grp, st in opt.state_dict().items()})
    first = _run_epochs(steps, batches, plan, 1, gen, first=1)
    after = [p.detach().clone() for p in tm.parameters()]
    n_graphs, replays = len(steps.graphs), steps.graphs.replays
    tm.load_state_dict(saved[0])
    opt.load_state_dict(saved[1])
    again = _run_epochs(steps, batches, plan, 1, gen, first=1)
    assert len(steps.graphs) == n_graphs
    assert steps.graphs.replays == replays + sum(map(bool, plan))
    assert again[0][0] == pytest.approx(first[0][0], rel=LOSS_RTOL)
    _close_rel([p.detach() for p in tm.parameters()], after, "resumed")


# ------------------------------------------------- the dense-subgraph route
#
# One learned step, dense_subgraph 'on' against 'off', from the same
# parameters and generator seed (the routes draw the same samples), no
# dropout. In f32 the routes differ by the order of f32 sums (K1/K2
# atomics against the products'): the layer tests' limits, 1e-5 on the
# loss and 1e-4 relative L2 per gradient. In bf16 both routes round each
# aggregation's output to bf16, so the order of the f32 sums can flip a
# rounding: chip_smoke.py's grad_check limits, 1% and 5%. Launches per
# step (derived as chip_smoke.py's ``model_launches``): the scorer's GCN
# encoder (K1 4, K2 2) and the random forward (GCN K1 4, K2 2; GAT K1 4,
# K2 8) leave K1 and K2; the learned backbone and reg2 (K1 2) stay, and
# the learned backbone's backward of its K1 and K2 (rows_at 4). On
# the sparse route two_pass's first pass (no backward) aggregates its bf16
# encoder on K8 (``ops/spmm.py`` ``auto_route``: 2 launches), which the
# dense route replaces too.
DENSE_CASES = {
    "hybrid_gcn": (dict(pipeline="hybrid"), dict(
        scatter_add=6, segment_sum_scalar=2, rows_at=4)),
    "two_pass_gcn": (dict(pipeline="two_pass"), dict(
        scatter_add=6, segment_sum_scalar=2, rows_at=4)),
    "hybrid_gat": (dict(pipeline="hybrid", GNN="GAT"), dict(
        scatter_add=6, segment_sum_scalar=8, rows_at=4)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_route_on_card_matches_sparse(card, case, dtype):
    from sgs_gnn_tpu_torch import Config, Graph, get_model
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.train.pipelines import make_learned_loss
    kw, rows = DENSE_CASES[case]
    rng = np.random.default_rng(3)
    n, e, f, c, q = 700, 40_000, 48, 6, 8_000
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    train = rng.random(n) < 0.6
    g = Graph.build(rng.normal(size=(n, f)).astype(np.float32), ei,
                    rng.integers(0, c, n).astype(np.int32), train, ~train,
                    None, prob=degree_prior(ei[0], ei[1], n), num_classes=c,
                    sort_by_receiver=True, device=card)
    out = {}
    for dense in ("off", "on"):
        cfg = Config(mode="learned", conditional=True, sparse_edge_mlp=True,
                     reg1=True, reg2=True, nhid=64, drop_rate=0.0,
                     dtype=dtype, dense_subgraph=dense,
                     edge_mlp_type="GCN", **kw)
        tm = get_model(cfg.GNN, f, cfg.nhid, c, 0.0, "GCN", dtype=dtype,
                       device=card, generator=torch.Generator().manual_seed(0))
        LAUNCHES.clear()
        loss, _ = make_learned_loss(cfg, tm, q)(
            g, torch.Generator(device=card).manual_seed(1))
        names, params = zip(*tm.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        out[dense] = (float(loss.detach()), {
            k: torch.zeros_like(p) if gr is None else gr
            for k, p, gr in zip(names, params, grads)}, dict(LAUNCHES))
    (loss_s, g_s, l_s), (loss_d, g_d, l_d) = out["off"], out["on"]
    assert all(l_d.get(k, 0) == v for k, v in rows.items()), l_d
    assert l_s["scatter_add"] > l_d["scatter_add"]
    k8 = 2 * (case == "two_pass_gcn" and dtype == "bfloat16"
              and sp.spmm_plan(n, 1, e, 2).route == "tiles")
    assert l_s.get("spmm_fused", 0) == k8 and "spmm_fused" not in l_d
    assert {k: v for k, v in l_d.items() if k not in rows} == \
        {k: v for k, v in l_s.items() if k not in rows and k != "spmm_fused"}
    loss_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (1e-2, 5e-2)
    assert abs(loss_d - loss_s) <= loss_tol * abs(loss_s)
    for k, want in g_s.items():
        assert bool(torch.isfinite(g_d[k]).all()), k
        if float(want.norm()) > 0:
            assert _rel_l2(g_d[k], want.float().cpu()) <= grad_tol, k


def test_segment_profiler_reads_memory_on_card(card):
    """--gpu_profile on the card: every segment's peak above the
    allocation before it is finite and >= 0, the segments that allocate
    their outputs report > 0, and the profiler keeps the peak that its
    resets hide."""
    from sgs_gnn_tpu_torch import Config, Graph, get_model
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.utils import device_memory_mb, make_segment_profiler
    rng = np.random.default_rng(4)
    n, e, f, c, q = 900, 60_000, 64, 5, 12_000
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    train = rng.random(n) < 0.6
    g = Graph.build(rng.normal(size=(n, f)).astype(np.float32), ei,
                    rng.integers(0, c, n).astype(np.int32), train, ~train,
                    None, prob=degree_prior(ei[0], ei[1], n), num_classes=c,
                    sort_by_receiver=True, device=card)
    cfg = Config(mode="learned", pipeline="hybrid", conditional=True,
                 sparse_edge_mlp=True, reg1=True, reg2=True, nhid=64,
                 dtype="bfloat16")
    tm = get_model("GCN", f, cfg.nhid, c, cfg.drop_rate, "GCN",
                   dtype="bfloat16", device=card,
                   generator=torch.Generator().manual_seed(0))
    big = torch.empty(256 * 2**20, dtype=torch.uint8, device=card)
    del big                              # a peak of >= 256 MiB, now freed
    peak = device_memory_mb(card)["peak_mb"]
    assert peak >= 256
    prof = make_segment_profiler(cfg, tm, q)
    ms, mb = prof(g, torch.Generator(device=card).manual_seed(2))
    assert all(v > 0 for v in ms.values()), ms
    assert all(np.isfinite(v) and v >= 0 for v in mb.values()), mb
    assert all(mb[k] > 0 for k in ("edge_mlp_pre", "edge_score",
                                   "gnn_forward", "backward")), mb
    assert device_memory_mb(card)["peak_mb"] < peak       # reset by the run
    assert prof.peak_mb >= peak


# ---------------------------------- the baselines; tensor parallel at tp 1
#
# f32 on both sides: the card sums with f32 atomics (K1, K2) in another
# order than the CPU's plain versions, so values agree to 1e-5 and
# gradients to 1e-4 (relative L2), as the f32 layer tests above. The
# baselines stay in f32 here because NeuralSparse's per-node top-k is a
# discrete pick: a bf16 rounding of a score near a node's k-th can swap an
# edge, which no relative limit bounds.


def _baseline_graph(rng, n=600, e=20_000, f_in=64):
    x = torch.from_numpy(rng.normal(size=(n, f_in)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 5, n).astype(np.int64))
    return x, s, r, y


@pytest.mark.parametrize("name", ["neuralsparse", "sparsegat"])
def test_baseline_step_on_card_matches_cpu(card, name, monkeypatch):
    """One forward and backward of NeuralSparseGCN (its Gumbel noise fixed)
    and of SparseGAT (deterministic gates) on the card, against the CPU
    from the same weights: K1 and K2 launched on the card, none on the
    CPU; outputs and every gradient within the f32 limits above."""
    from sgs_gnn_tpu_torch.baselines import (NeuralSparseGCN, SparseGAT,
                                             neuralsparse)
    rng = np.random.default_rng(11)
    x, s, r, y = _baseline_graph(rng)
    noise = torch.from_numpy(rng.gumbel(size=s.shape[0]).astype(np.float32))
    monkeypatch.setattr(neuralsparse, "gumbel",
                        lambda gen, shape, device: noise.to(device))
    out, grads, launched = {}, {}, {}
    for side, dev in (("card", card), ("cpu", "cpu")):
        gen = torch.Generator().manual_seed(0)
        model = (NeuralSparseGCN(64, 32, 5, k=8, device=dev, generator=gen)
                 if name == "neuralsparse" else
                 SparseGAT(64, s.shape[0], 32, 5, device=dev, generator=gen))
        LAUNCHES.clear()
        res = model(x.to(dev), s.to(dev), r.to(dev), None,
                    deterministic=True)
        logits = res if name == "neuralsparse" else res[0]
        loss = torch.nn.functional.cross_entropy(logits, y.to(dev))
        if name == "sparsegat":
            loss = loss + 1e-3 * res[1] / s.shape[0]
        names, params = zip(*model.named_parameters())
        g = torch.autograd.grad(loss, params)
        if dev != "cpu":
            torch.cuda.synchronize()
        out[side] = logits.detach().cpu()
        grads[side] = {n: gr.cpu() for n, gr in zip(names, g)}
        launched[side] = dict(LAUNCHES)
    assert launched["card"].get("scatter_add", 0) > 0, launched
    assert launched["card"].get("segment_sum_scalar", 0) > 0, launched
    assert not launched["cpu"]
    assert _rel_l2(out["card"], out["cpu"]) <= 1e-5
    for n, want in grads["cpu"].items():
        assert _rel_l2(grads["card"][n], want) <= 1e-4, n


def test_tp1_step_on_card_matches_sequential(card, monkeypatch):
    """``shard_params_tp`` on a one-rank NCCL group (``make_dp_tp_mesh(1,
    1)``: every shard whole, every collective an identity) against the
    unsharded model, f32, hybrid_rescore without a tile index, dropout 0,
    the sample frozen (the sharded head runs unfused, the unsharded one K3
    and K5, so their probabilities differ by f32 rounding, which could
    swap a sampled edge at the top-k boundary): the learned loss and every
    gradient within the f32 limits; then one ``make_train_step`` of each,
    the sharded one launching K1 and K2 and no head kernel (K3, K5,
    K6)."""
    import torch.distributed as dist
    from sgs_gnn_tpu_torch import (Config, DualOptimizer, Graph, get_model,
                                   make_train_step)
    from sgs_gnn_tpu_torch.parallel import (init_distributed,
                                            make_dp_tp_mesh,
                                            shard_params_tp)
    from sgs_gnn_tpu_torch.train import pipelines
    from sgs_gnn_tpu_torch.train.pipelines import make_learned_loss
    rng = np.random.default_rng(5)
    x, s, r, y = _baseline_graph(rng, n=800, e=40_000, f_in=48)
    idx = torch.from_numpy(np.sort(rng.choice(40_000, 8000, replace=False))
                           .astype(np.int32)).to(card)
    rand_idx = torch.from_numpy(rng.choice(40_000, 8000, replace=False)
                                .astype(np.int32)).to(card)

    def frozen(generator, probs, prior, q, beta, istest=False,
               edge_mask=None):
        return idx, probs[idx.long()]

    monkeypatch.setattr(pipelines, "sample_edges", frozen)
    monkeypatch.setattr(pipelines, "sample_prior_edges",
                        lambda *a, **k: rand_idx)
    train = rng.random(800) < 0.5
    g = Graph.build(x.numpy(), np.stack([s.numpy(), r.numpy()]), y.numpy(),
                    train, ~train, None, num_classes=5,
                    sort_by_receiver=True, device=card)
    cfg = Config(mode="learned", pipeline="hybrid", conditional=True,
                 sparse_edge_mlp=True, reg1=True, reg2=True, nhid=64,
                 drop_rate=0.0)
    started = not dist.is_initialized()
    if started:
        init_distributed(device=card)
    try:
        mesh = make_dp_tp_mesh(1, 1)
        models = [get_model("GCN", 48, 64, 5, 0.0, "GCN", device=card,
                            generator=torch.Generator().manual_seed(2))
                  for _ in range(2)]
        shard_params_tp(models[1], mesh)
        res = []
        for m in models:
            loss, _ = make_learned_loss(cfg, m, 8000)(
                g, torch.Generator(device=card).manual_seed(3))
            names, params = zip(*m.named_parameters())
            res.append((float(loss.detach()), dict(zip(
                names, torch.autograd.grad(loss, params)))))
        (loss_seq, g_seq), (loss_tp, g_tp) = res
        assert loss_tp == pytest.approx(loss_seq, rel=1e-5)
        for n, want in g_seq.items():
            assert _rel_l2(g_tp[n], want.cpu()) <= 1e-4, n
        launched = []
        for m in models:
            opt = DualOptimizer.create(m, cfg.GNN, cfg.lr, cfg.weight_decay)
            step = make_train_step(cfg, m, opt, 8000, 5)
            LAUNCHES.clear()
            metrics = step(g, 0, torch.Generator(device=card).manual_seed(4))
            torch.cuda.synchronize()
            assert bool(torch.isfinite(metrics.loss))
            launched.append(dict(LAUNCHES))
        seq, tp = launched
        assert seq.get("score_head_sampled_banded", 0) == 1, seq
        assert tp.get("scatter_add", 0) > 0, tp
        assert tp.get("segment_sum_scalar", 0) > 0, tp
        for k in ("score_head_sampled", "score_head_sampled_banded",
                  "score_head_bwd", "score_head_tiles"):
            assert k not in tp, tp
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.quality
def test_learned_beats_random_and_full_on_card():
    """tests/test_quality.py's claim through the port on the card."""
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.data import get_dataset
    from sgs_gnn_tpu_torch.run import driver
    cfg = Config(dataset="SyntheticSBMLow", pipeline="hybrid", GNN="GCN",
                 edge_mlp_type="GCN", conditional=True, reg1=True,
                 reg2=True, sample_perc=0.2, nhid=64, epochs=60, runs=1,
                 save_csv=False, donate=False, num_samples_eval=3,
                 convergence=0.0)
    ds = get_dataset(cfg)
    assert ds.He < 0.25, ds.He
    f1 = {m: driver.run_experiment(cfg.replace(mode=m), ds,
                                   log_fn=lambda *a: None)[0].final_test_f1
          for m in ("learned", "random", "full")}
    assert f1["learned"] > f1["random"] + 0.2, f1
    assert f1["learned"] > f1["full"] + 0.1, f1


# ------------------------------------------ device stamps (core/spans.py)
#
# Stamps only read the clock: a graph captured with them must give the
# outputs of one captured without them. Where two unstamped runs agree bit
# for bit the stamped one must too; where the order of f32 atomics differs
# between runs, it stays within the graphed route's own limits.
#
# A graphed training epoch is held otherwise: its low bits differ from run
# to run, with stamps or without. K1's "sort" mode adds each chunk's slab
# into the output with f32 atomics in the order its blocks finish, so no
# two identical calls agree bit for bit (40 distinct sums of 40 on an
# H100), and a loss or a parameter that this noise reaches only through
# rounding agrees between two runs as often as not and then differs in a
# third (16 runs: 3-6 distinct losses among the unstamped runs, the
# stamped runs' among them). Two runs that agree there say nothing of a
# third. So the epoch is held to what the stamps may not change: the same
# kernels, as many times each, stamps aside; and its values to the
# graphed route's own limit (``_close_rel``).


def _stamps_on():
    from sgs_gnn_tpu_torch.core import spans
    spans.reset()
    spans.enable(device_stamps=True)


def _stamps_off():
    from sgs_gnn_tpu_torch.core import spans
    spans.disable()
    spans.reset()


def _same_as_unstamped(got, a, b, what):
    for i, (g, x, y) in enumerate(zip(got, a, b)):
        if torch.equal(x, y):
            assert torch.equal(g, x), (what, i)
        else:
            dist = float((g.float() - x.float()).norm())
            assert dist <= PARAM_REL_L2 * float(x.float().norm()), (what, i)


def test_stamp_kernel_builds_and_credits_the_work_before_it(card):
    from sgs_gnn_tpu_torch.core import spans
    x = torch.randn(1 << 22, device=card)
    _stamps_on()
    try:
        spans.stamp("start", card)
        for _ in range(20):
            x = x * 1.0001 + 0.5
        spans.stamp("work", card)
        with spans.phase("step"):
            spans.stamp("work", card)
        torch.cuda.synchronize()
        seg = spans.collect()["segments"]
    finally:
        _stamps_off()
    # the first stamp after a reset has no previous one
    assert seg["start"] == {"stamps": 1, "s": 0.0}
    assert seg["work"]["stamps"] == 1 and seg["work"]["s"] > 0
    assert seg["step.work"]["stamps"] == 1


def _kernels_run(prof):
    """The device's kernels, copies and sets in a profiled stretch, the
    stamps and the host spans' device ranges (``sgs.*``) aside: name ->
    count. The CUDA driver runs a graph's copy or set node on the copy
    engine or as a kernel of its own (``memcpy32_post``, ``memset32``), as
    it lowers the graph, so each counts under one name either way."""
    from torch.autograd import DeviceType
    from sgs_gnn_tpu_torch.core import spans
    names = collections.Counter()
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or "stamp_kernel" in e.name
                or e.name.startswith(spans.PREFIX)):
            continue
        if e.name.startswith("Memcpy DtoD") or re.fullmatch(
                r"memcpy\d*(_\w+)?", e.name):
            names["copy on the device"] += 1
        elif e.name.startswith("Memset") or re.fullmatch(
                r"memset\d*(_\w+)?", e.name):
            names["set on the device"] += 1
        else:
            names[e.name] += 1
    return names


@pytest.mark.parametrize("name", ["hybrid_rescore", "random"])
def test_stamped_graphs_give_the_unstamped_outputs(card, name):
    """A learned and a random graphed epoch captured with stamps: the
    replays run the kernels of those without stamps, as many times each,
    and give their losses and parameters within the graphed route's limit;
    every layer's segment > 0, one optimizer stamp per replayed step, and
    the segments of the replays (``between`` included) within the host
    wall time of those replays."""
    from torch.profiler import ProfilerActivity, profile
    from sgs_gnn_tpu_torch import Config
    from sgs_gnn_tpu_torch.core import spans
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    cfg = Config(**GRAPHED_BASE, **GRAPHED_KW[name])
    batches, plan, q, classes = _graphed_batches(card, cfg)
    runs = []
    for stamped in (False, False, True):
        if stamped:
            _stamps_on()
        try:
            tm, opt = _graphed_model(card, cfg, batches, classes)
            steps = make_scan_epoch_step(cfg, tm, opt, q, 4, len(batches))
            gen = torch.Generator(device=card)
            sums = _run_epochs(steps, batches, plan, 1, gen)   # captures
            torch.cuda.synchronize()
            spans.reset()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sums += _run_epochs(steps, batches, plan, 2, gen, first=1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            seg = spans.collect()["segments"]
        finally:
            _stamps_off()
        runs.append((torch.tensor(sums), [p.detach().clone()
                                           for p in tm.parameters()],
                     seg, wall, _kernels_run(prof)))
    ((s_a, p_a, seg_a, _, k_a), (s_b, p_b, _, _, k_b),
     (s_s, p_s, seg, wall, k_s)) = runs
    assert seg_a == {}
    assert k_a and k_s == k_a == k_b, (k_s - k_a, k_a - k_s)
    for s_u, p_u in ((s_a, p_a), (s_b, p_b)):
        _close_rel([s_s], [s_u], name + " losses")
        _close_rel(p_s, p_u, name)
    layers = ["between", "backbone", "loss", "optimizer"]
    if name == "hybrid_rescore":
        layers += ["scorer", "sampler"]
    trained = 2 * sum(map(bool, plan))
    for layer in layers:
        assert seg[f"step.{layer}"]["s"] > 0, (layer, seg)
    assert seg["step.optimizer"]["stamps"] == trained
    assert seg["step.between"]["stamps"] == trained
    assert sum(v["s"] for v in seg.values()) <= wall


def test_stamped_predict_gives_the_unstamped_outputs(card):
    from sgs_gnn_tpu_torch import make_predictor
    from sgs_gnn_tpu_torch.core import spans
    cfg, g, tm, q = _serve_model(card)
    runs = []
    for stamped in (False, False, True):
        if stamped:
            _stamps_on()
        try:
            predict = make_predictor(cfg, tm, q)
            gen = torch.Generator(device=card)
            out = [predict(g, gen.manual_seed(s)) for s in (1, 2)]
            torch.cuda.synchronize()
            spans.reset()
            t0 = time.perf_counter()
            out += [predict(g, gen.manual_seed(s)) for s in (1, 2, 3)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seg = spans.collect()["segments"]
        finally:
            _stamps_off()
        runs.append(([t for pair in out for t in pair], seg, wall))
    (a, _, _), (b, _, _), (got, seg, wall) = runs
    _same_as_unstamped(got, a, b, "predict")
    draws = cfg.num_samples_eval
    assert seg["serve.sampler"]["stamps"] == 3 * draws
    assert seg["serve.backbone"]["stamps"] == 3 * draws
    for layer in ("between", "scorer", "sampler", "backbone"):
        assert seg[f"serve.{layer}"]["s"] > 0, (layer, seg)
    assert sum(v["s"] for v in seg.values()) <= wall


def test_stamped_gin_mlp_predict_gives_the_unstamped_outputs(card):
    """GIN + MLP ``predict`` in f32 (every GIN sum on the gather route and
    K1): the logits with the stamps on within the graphed route's limit of
    those with them off (K1's f32 atomics may add in another order when
    the stamps shift the kernels' timing; on the CPU they are bit-equal,
    ``tests/test_torch_gin_mlp.py``); each draw's two sums stamped
    ``serve.aggregate`` (> 0); the message bytes counted on each replay,
    E x F x 4 a sum, with the stamps on and off."""
    from sgs_gnn_tpu_torch import Config, Graph, get_model, make_predictor
    from sgs_gnn_tpu_torch.core import spans
    from sgs_gnn_tpu_torch.data import degree_prior
    rng = np.random.default_rng(1)
    n, e, f, c = 300, 20_000, 24, 5
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    g = Graph.build(rng.normal(size=(n, f)).astype(np.float32), ei,
                    rng.integers(0, c, n).astype(np.int32),
                    prob=degree_prior(ei[0], ei[1], n), num_classes=c,
                    sort_by_receiver=True, device=card)
    cfg, q = Config(nhid=32, num_samples_eval=4), 4_000
    tm = get_model("GIN", f, cfg.nhid, c, cfg.drop_rate, "MLP",
                   dtype=cfg.dtype, device=card,
                   generator=torch.Generator().manual_seed(0))
    runs = []
    for stamped in (False, True):
        if stamped:
            _stamps_on()
        try:
            predict = make_predictor(cfg, tm, q)
            gen = torch.Generator(device=card)
            out = [predict(g, gen.manual_seed(s))[0] for s in (1, 2)]
            torch.cuda.synchronize()
            spans.reset()
            out += [predict(g, gen.manual_seed(s))[0] for s in (1, 2, 3)]
            torch.cuda.synchronize()
            got = spans.collect()
        finally:
            _stamps_off()
        runs.append((out, got))
    (off, off_rec), (on, on_rec) = runs
    _close_rel(on, off, "gin predict")
    assert off_rec["segments"] == {}
    seg = on_rec["segments"]
    assert seg["serve.aggregate"]["stamps"] == 3 * cfg.num_samples_eval * 2
    assert seg["serve.aggregate"]["s"] > 0 and seg["serve.backbone"]["s"] > 0
    for rec in (off_rec, on_rec):
        assert rec["counters"]["kernels.bytes.spmm.gather_k1"] == \
            3 * cfg.num_samples_eval * q * (f + cfg.nhid) * 4


# ------------------------------------------- the ordered top-q draw (topq)

def _topq_inputs(card, e, kind, keys, seed=0):
    """(u, logw or None, mask or None) of one draw over e entries: "distinct"
    keys, "tied" keys (64 levels of u and of logw, so the threshold's level
    is split), or "masked" (-inf keys, 30 % valid)."""
    from sgs_gnn_tpu_torch.ops import sampling_ops as so
    g = torch.Generator(device=card).manual_seed(seed)
    u = torch.rand(e, generator=g, device=card)
    logw = so.log_weights(torch.rand(e, generator=g, device=card))
    mask = None
    if keys == "tied":
        u = torch.randint(1, 65, (e,), generator=g, device=card).float() / 65
        logw = so.log_weights(torch.randint(1, 65, (e,), generator=g,
                                            device=card).float())
    elif keys == "masked":
        mask = torch.rand(e, generator=g, device=card) < 0.3
    return u, logw if kind == "gumbel" else None, mask


# (E, q): the main path's draw, tiles of one entry, a ragged last tile,
# a whole tile, q = E, q = 1, and q above the valid count with the mask
TOPQ_SHAPES = [(1_065_984, 200_000), (1, 1), (37, 5), (4097, 4096),
               (4096, 4096), (10_000, 1), (50_003, 20_001)]


@pytest.mark.parametrize("keys", ["distinct", "tied", "masked"])
@pytest.mark.parametrize("kind", ["gumbel", "uniform"])
@pytest.mark.parametrize("e,q", TOPQ_SHAPES)
def test_topq_kernel_matches_the_plain_version(card, e, q, kind, keys):
    """The kernel's ids equal the plain version's on the same keys (formed
    by torch's ops on the card), bit for bit: the same set, ascending, ties
    at the threshold to the lowest ids, masked entries only once the valid
    ones run out."""
    from sgs_gnn_tpu_torch.ops import sampling_ops as so
    u, logw, mask = _topq_inputs(card, e, kind, keys)
    got = _one_launch("topq", kind,
                      lambda: so.topq_ordered(u, q, logw=logw, mask=mask))
    want = so.topq_ordered_plain(so.draw_keys(u, logw, mask), q)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["gumbel", "uniform"])
def test_topq_keys_equal_the_formula_bit_for_bit(card, kind):
    """The images the kernel leaves in its scratch decode to the keys of
    ``gumbel_topk``'s / ``uniform_topk``'s torch ops on the card, bit for
    bit (-0 read as +0); u = 0 clamps to the smallest normal."""
    from sgs_gnn_tpu_torch.ops import sampling_ops as so
    e, q = 1_065_984, 200_000
    u, logw, mask = _topq_inputs(card, e, kind, "masked", seed=3)
    u[:7] = 0.0
    if logw is not None:
        logw[7:9] = so.log_weights(torch.zeros(2, device=card))
    _, scratch = so._topq_cuda(u, q, logw, mask)
    img = scratch[-e:]
    bits = torch.where(img < 0, img ^ torch.iinfo(torch.int32).min, ~img)
    want = so.draw_keys(u, logw, mask) + 0.0
    assert torch.equal(bits, want.view(torch.int32))


def test_topq_replays_in_a_cuda_graph_with_new_uniforms(card):
    """A captured draw replays with the uniforms its buffer holds: each
    replay's ids equal the plain version's on that replay's keys."""
    from sgs_gnn_tpu_torch.ops import sampling_ops as so
    e, q = 300_000, 60_000
    _, logw, _ = _topq_inputs(card, e, "gumbel", "distinct", seed=1)
    mask = torch.rand(e, device=card) < 0.9
    u = torch.rand(e, device=card)
    so.topq_ordered(u, q, logw=logw, mask=mask)      # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids = so.topq_ordered(u, q, logw=logw, mask=mask)
    gen = torch.Generator(device=card)
    for seed in (1, 2, 3):
        u.copy_(torch.rand(e, generator=gen.manual_seed(seed), device=card))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ids, so.topq_ordered_plain(
            so.draw_keys(u, logw, mask), q))


def test_topq_counts_routes_and_ties(card):
    """``ROUTES[("topq", formula)]`` counts each draw; the kernel's tie
    counter adds the draws whose threshold had more equal keys than they
    took, and the tied ids they took, as the plain keys say."""
    from sgs_gnn_tpu_torch.ops import sampling_ops as so
    e, q = 200_000, 40_000
    so.reset_topq_ties()
    want = {"draws": 0, "ids": 0}
    for kind in ("gumbel", "uniform"):
        for keys in ("distinct", "tied"):
            u, logw, mask = _topq_inputs(card, e, kind, keys, seed=5)
            _one_launch("topq", kind,
                        lambda: so.topq_ordered(u, q, logw=logw, mask=mask))
            k = so.draw_keys(u, logw, mask)
            t = torch.topk(k, q).values.min()
            need = q - int((k > t).sum())
            if int((k == t).sum()) > need:
                want["draws"] += 1
                want["ids"] += need
    assert want["draws"] >= 2            # the tied keys break ties
    assert so.topq_ties() == want


def test_served_gin_draws_put_k1_in_rows_mode(card):
    """GIN + MLP ``predict`` on a receiver-sorted edge list: the draws'
    ascending ids hand K1 sorted receivers, so every slab chunk of its sums
    takes "rows" mode; a served request and an evaluated batch run the
    topq kernel and neither torch.topk nor a sort."""
    from sgs_gnn_tpu_torch import (Config, Graph, get_model, make_eval_step,
                                   make_predictor)
    from sgs_gnn_tpu_torch.data import degree_prior
    rng = np.random.default_rng(2)
    n, e, f, c = 2048, 200_000, 64, 5
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    g = Graph.build(rng.normal(size=(n, f)).astype(np.float32), ei,
                    rng.integers(0, c, n).astype(np.int32),
                    prob=degree_prior(ei[0], ei[1], n), num_classes=c,
                    sort_by_receiver=True, device=card)
    cfg, q = Config(nhid=64, num_samples_eval=3), 40_000
    tm = get_model("GIN", f, cfg.nhid, c, cfg.drop_rate, "MLP",
                   dtype=cfg.dtype, device=card,
                   generator=torch.Generator().manual_seed(0))
    predict = make_predictor(cfg, tm, q)
    gen = torch.Generator(device=card)
    predict(g, gen.manual_seed(1))                  # eager + capture
    torch.cuda.synchronize()
    sc.reset_slab_chunk_modes()
    launches = collections.Counter(LAUNCHES)
    predict(g, gen.manual_seed(2))
    modes = sc.slab_chunk_modes()
    assert (LAUNCHES - launches)["topq"] == cfg.num_samples_eval
    assert modes["sort"] == 0 and modes["rows"] > 0, modes
    evaluate = make_eval_step(cfg, tm, q)
    for call in (predict, evaluate):
        call(g, gen.manual_seed(3))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call(g, gen.manual_seed(3))
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()]
        assert any("topq_write_kernel" in k for k in names), names
        # torch.topk's radix select and torch.sort's kernels
        assert not any(lib in k for k in names for lib in (
            "mbtopk", "RadixSort", "bitonicSort", "sortKeyValue")), names


# ---------------------------------------- GCNII (models/backbones.py)


@pytest.mark.parametrize("weighted", [False, True])
def test_forward_only_spmm_takes_k8_at_2048_columns(card, weighted):
    """GCNII's propagation width: K8's tile route in 8 column slices of
    256, held as ``test_forward_only_spmm_takes_k8`` holds one slice."""
    plan = sp.spmm_plan(2123, 2048, 200_000, 2)
    assert (plan.route, plan.width, plan.slices) == ("tiles", 256, 8)
    test_forward_only_spmm_takes_k8(card, 2048, weighted)


def _gcnii(dtype, dev):
    from sgs_gnn_tpu_torch.models.backbones import GCNIIModel
    return GCNIIModel(96, 32, 7, 0.3, "GCN", dtype=dtype,
                      generator=torch.Generator().manual_seed(4)).to(dev)


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_gcnii_on_card_matches_cpu_f32(card, grad):
    """GCNII at its published 9 x 2048 in bf16 on the card against the
    port's f32 on the CPU: forward only, every propagation on K8's tiles
    (8 slices); with a backward, every propagation on the gather route and
    K1 at 2048 bf16 columns. Limits as ``test_layer_on_card_matches_cpu_
    f32``'s: the larger of 2% / 5% and twice the CPU bf16 run's own
    error."""
    rng = np.random.default_rng(8)
    n, e = 400, 40_000
    x = torch.from_numpy(rng.normal(size=(n, 96)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, e).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32))
    out, grads, routes = {}, {}, {}
    for side, dev, dt in (("card", card, torch.bfloat16),
                          ("cpu", "cpu", torch.float32),
                          ("cpu_bf16", "cpu", torch.bfloat16)):
        model = _gcnii(dt, dev)
        before = collections.Counter(sp._build.ROUTES)
        with torch.set_grad_enabled(grad):
            y = model(x.to(dev), s.to(dev), r.to(dev), w.to(dev))
        routes[side] = collections.Counter(sp._build.ROUTES) - before
        out[side] = y.detach().float().cpu()
        if grad:
            names, params = zip(*[(k, p) for k, p in
                                  model.named_parameters() if "GCNII" in k])
            g = torch.autograd.grad(y, list(params), cot.to(dev))
            grads[side] = dict(zip(names, (t.float().cpu() for t in g)))
    want_route = "gather_k1" if grad else "k8_tiles"
    assert routes["card"][("spmm", want_route)] == 9, routes["card"]
    assert _rel_l2(out["card"], out["cpu"]) <= max(
        2e-2, 2 * _rel_l2(out["cpu_bf16"], out["cpu"]))
    for name, want in grads.get("cpu", {}).items():
        tol = max(5e-2, 2 * _rel_l2(grads["cpu_bf16"][name], want))
        assert _rel_l2(grads["card"][name], want) <= tol, name


def test_stamped_gcnii_predict(card):
    """GCNII + GCN ``predict`` at the published widths, every propagation
    on K8: the logits with the stamps on within a relative 1e-2 of those
    with them off (K8 adds its split-K parts with f32 atomics in no fixed
    order, and nine bf16 layers carry a flipped rounding on); each draw's
    nine propagations stamped ``serve.aggregate`` (> 0); no message
    matrix written."""
    from sgs_gnn_tpu_torch import Config, Graph, make_predictor
    from sgs_gnn_tpu_torch.core import spans
    from sgs_gnn_tpu_torch.data import degree_prior
    rng = np.random.default_rng(2)
    n, e, c = 300, 20_000, 7
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    g = Graph.build(rng.normal(size=(n, 96)).astype(np.float32), ei,
                    rng.integers(0, c, n).astype(np.int32),
                    prob=degree_prior(ei[0], ei[1], n), num_classes=c,
                    sort_by_receiver=True, device=card)
    cfg, q = Config(nhid=32, num_samples_eval=4, GNN="GCNII"), 4_000
    tm = _gcnii(torch.bfloat16, card)
    runs = []
    for stamped in (False, True):
        if stamped:
            _stamps_on()
        try:
            predict = make_predictor(cfg, tm, q)
            gen = torch.Generator(device=card)
            out = [predict(g, gen.manual_seed(s))[0] for s in (1, 2)]
            torch.cuda.synchronize()
            spans.reset()
            out += [predict(g, gen.manual_seed(s))[0] for s in (1, 2, 3)]
            torch.cuda.synchronize()
            got = spans.collect()
        finally:
            _stamps_off()
        runs.append((out, got))
    (off, off_rec), (on, on_rec) = runs
    for a, b in zip(on, off):
        assert _rel_l2(a, b.float().cpu()) <= 1e-2
    assert off_rec["segments"] == {}
    seg = on_rec["segments"]
    assert seg["serve.aggregate"]["stamps"] == 3 * cfg.num_samples_eval * 9
    assert seg["serve.aggregate"]["s"] > 0 and seg["serve.backbone"]["s"] > 0
    for rec in (off_rec, on_rec):
        assert "kernels.bytes.spmm.gather_k1" not in rec["counters"]
        assert rec["counters"]["kernels.routes.spmm.k8_tiles"] == \
            3 * (cfg.num_samples_eval * 9 + 2)

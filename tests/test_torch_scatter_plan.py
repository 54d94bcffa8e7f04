"""How the row scatter (K1, ``csrc/scatter.cu``) and the degree sum (K2,
``csrc/segment_sum.cu``) cut a call, on the CPU: ``scatter_plan`` and
``segment_plan`` are plain functions of the shapes, so their limits, their
coverage of the work and a numpy emulation of the kernels' partition are
checked here; the kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch.ops import scatter as sc

NS = [1, 37, 2048, 12288, 100_000]
FS = [1, 41, 256, 300]


def _walkers(plan, itemsize):
    """The ways one block splits its chunk: slab blocks into walkers of
    W / V lanes (V = 16 / itemsize columns per lane with 16-byte loads, or
    1; a chunk that looks sorted splits over the sibling blocks' warps, as
    the sorted order of an unsorted one splits over the walkers), direct
    blocks into warps."""
    if plan.route == "direct":
        return [sc.DIRECT_WARPS]
    return [sc.SLAB_THREADS * v // plan.col_tile
            for v in {1, 16 // itemsize} if plan.col_tile % v == 0]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", [132, 114])
def test_scatter_plan_shared_memory_within_limit(itemsize, sms):
    for n in list(range(1, 300)) + [1000, 2048, 3632, 3633, 7264, 7265,
                                    12288, 58112, 58113, 100_000]:
        for f in (1, 2, 3, 16, 41, 64, 256, 300, 602):
            plan = sc.scatter_plan(n, f, itemsize, 200_000, sms)
            assert plan.smem_bytes <= sc.SMEM_LIMIT == 232_448
            if plan.route == "slab":
                assert plan.smem_bytes == sc.slab_smem(n, plan.col_tile,
                                                       plan.sub_items)
                assert sc.slab_stride(n) % 8 == 2
                assert 1 <= plan.sub_items <= sc.SORT_MAX_ITEMS
                assert n < sc.SLAB_MAX_SEGMENTS
                # the blocks the chunks assume fit on one SM
                per_sm = min(sc.SMEM_PER_SM // (plan.smem_bytes + 1024), 2)
                assert plan.col_tiles * plan.chunks <= per_sm * sms
                assert 32 % plan.col_tile == 0
            else:
                assert plan.route == "direct"
                assert plan.smem_bytes == plan.sub_items == 0
                assert plan.col_tile == sc.DIRECT_TILE
                assert plan.chunk_items % sc.DIRECT_WARPS == 0
            assert plan.chunks <= sc.MAX_GRID_Y


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("f", FS)
def test_scatter_plan_covers_each_column_and_edge_once(n, f):
    for itemsize in (2, 4):
        for e in (1, 31, 4097, 200_003):
            plan = sc.scatter_plan(n, f, itemsize, e)
            cols = np.zeros(f, np.int64)
            for x in range(plan.col_tiles):
                cols[x * plan.col_tile:(x + 1) * plan.col_tile] += 1
            assert (cols == 1).all(), (plan, "columns")
            if plan.route == "slab":     # sort passes tile each chunk
                assert plan.sub_items <= plan.chunk_items
            for parts in _walkers(plan, itemsize):
                edges = np.zeros(e, np.int64)
                for y in range(plan.chunks):
                    e0 = y * plan.chunk_items
                    e1 = min(e0 + plan.chunk_items, e)
                    per = (-(-(e1 - e0) // parts) if plan.route == "slab"
                           else plan.chunk_items // parts)
                    for p in range(parts):
                        a = e0 + p * per
                        edges[a:min(a + per, e1)] += 1
                assert (edges == 1).all(), (plan, parts, "edges")


def test_scatter_plan_routes():
    """The route is a function of (N, F, itemsize): a slab wide enough for
    one 32-byte sector of a value row, else the direct route."""
    assert sc.scatter_plan(2048, 256, 2, 200_000) == sc.ScatterPlan(
        "slab", 16, 16, 25_000, 8, 12_500,
        4 * (16 * 2050 + 2048 + 12_500 + 32))
    assert sc.scatter_plan(2048, 41, 2, 200_000)[:3] == ("slab", 16, 3)
    assert sc.scatter_plan(37, 41, 4, 1001)[:3] == ("slab", 32, 2)
    assert sc.scatter_plan(5000, 256, 2, 50_001).route == "direct"
    assert sc.scatter_plan(5000, 256, 4, 50_001)[:2] == ("slab", 8)
    assert sc.scatter_plan(100_000, 1, 4, 10).route == "direct"
    for e in (1, 10_000, 1_000_000):
        assert {sc.scatter_plan(2048, 256, 2, e).route,
                sc.scatter_plan(12288, 256, 2, e).route} == {"slab", "direct"}


def _emulate_scatter(vals, ids, n, plan):
    """The kernel's partition in numpy: each block sums its chunk's rows of
    its column tile into a private (N, tile) partial (the slab, or the
    direct block's register runs), then adds the partial to the output."""
    e, f = vals.shape
    out = np.zeros((n, f), np.float64)
    keep = (ids >= 0) & (ids < n)
    for y in range(plan.chunks):
        e0, e1 = y * plan.chunk_items, min((y + 1) * plan.chunk_items, e)
        sel = np.arange(e0, e1)[keep[e0:e1]]
        for x in range(plan.col_tiles):
            c0, c1 = x * plan.col_tile, min((x + 1) * plan.col_tile, f)
            partial = np.zeros((n, c1 - c0), np.float64)
            np.add.at(partial, ids[sel], vals[sel, c0:c1])
            out[:, c0:c1] += partial
    return out


@pytest.mark.parametrize("n,f,e,ids_kind", [
    (37, 41, 5003, "hub"), (2048, 256, 20_011, "hub"),
    (2048, 41, 30_001, "random"), (64, 1, 4096, "sorted"),
    (5000, 300, 3001, "hub"), (5, 300, 333, "random")])
def test_scatter_partition_emulation_matches_plain(rng, n, f, e, ids_kind):
    vals = rng.normal(size=(e, f)).astype(np.float32)
    ids = rng.integers(-2, n + 2, e).astype(np.int32)
    if ids_kind == "hub":
        ids[rng.permutation(e)[:e // 2]] = n // 2
    elif ids_kind == "sorted":
        ids = np.sort(ids)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    ref = sc.scatter_add_plain(tv, ti, n).numpy()
    # the plain version sums in f32 (a hub row: 10k terms), the emulation
    # in f64: 1e-5 of the summed magnitudes + 1e-6, as on the card
    tol = 1e-5 * sc.scatter_add_plain(tv.abs(), ti, n).numpy() + 1e-6
    for itemsize in (2, 4):
        plan = sc.scatter_plan(n, f, itemsize, e, sms=16)
        got = _emulate_scatter(vals, ids, n, plan)
        assert (np.abs(got - ref) <= tol).all()


@pytest.mark.parametrize("ids_kind", ["sorted", "reversed", "random",
                                      "half_sorted", "unsampled_descent"])
def test_slab_chunk_sorted(rng, ids_kind):
    """The twin of the slab kernel's per-chunk pick: sorted chunks take
    "rows" mode, others "sort"; a descent between sampled items is not
    seen (either mode sums any ids)."""
    n, e = 2048, 200_003
    plan = sc.scatter_plan(n, 256, 2, e)
    assert plan.route == "slab" and plan.chunks == 8
    ids = np.sort(rng.integers(-2, n + 2, e)).astype(np.int32)
    want = np.ones(plan.chunks, bool)
    if ids_kind == "reversed":
        ids, want[:] = ids[::-1].copy(), False
    elif ids_kind == "random":
        rng.shuffle(ids)
        want[:] = False
    elif ids_kind == "half_sorted":
        rng.shuffle(ids[e // 2:])
        want[4:] = False      # chunk 3 ends 3 items past the sorted half
    elif ids_kind == "unsampled_descent":
        # chunk 1's samples sit at 25,001 + 24 t; a swap between two
        # items neither of which is sampled or follows a sample
        i = plan.chunk_items + 24 * 10 + 5
        ids[i], ids[i + 1] = ids[i] + 1, ids[i]
    assert (sc.slab_chunk_sorted(ids, plan) == want).all()
    if ids_kind == "unsampled_descent":
        assert not (np.diff(ids[plan.chunk_items:2 * plan.chunk_items])
                    >= 0).all()


@pytest.mark.parametrize("n", NS)
def test_segment_plan_covers_each_item_once(n):
    for e in (1, 33, 4097, 200_003, 1_000_000):
        plan = sc.segment_plan(n, e)
        assert plan.route == ("shared" if n <= 12_288 else "global")
        assert plan.smem_bytes == (4 * n if plan.route == "shared" else 0)
        assert plan.smem_bytes <= 48 * 1024
        assert plan.items_per_block % sc.SEGMENT_STEP == 0
        assert plan.blocks == -(-e // plan.items_per_block)
        assert (plan.blocks - 1) * plan.items_per_block < e
        assert plan.blocks <= max(1, -(-e // sc.SEGMENT_MIN_ITEMS))


def _emulate_segment_sum(w, ids, n, plan):
    """K2's partition in numpy: a block's warps take 32-item steps of its
    range in turn; in each step the run sums of equal adjacent ids (the
    segmented shuffle scan) are added once, into the block's histogram,
    which is then added to the output."""
    out = np.zeros(n, np.float64)
    e = w.shape[0]
    for b in range(plan.blocks):
        b0, b1 = b * plan.items_per_block, min((b + 1) * plan.items_per_block,
                                              e)
        hist = np.zeros(n, np.float64)
        for t in range(b0, b1, 32):
            i, v = ids[t:min(t + 32, b1)], w[t:min(t + 32, b1)]
            heads = np.flatnonzero(np.r_[True, i[1:] != i[:-1]])
            sums = np.add.reduceat(v.astype(np.float64), heads)
            for run_id, s in zip(i[heads], sums):
                if 0 <= run_id < n:
                    hist[run_id] += s
        out += hist
    return out


@pytest.mark.parametrize("ids_kind", ["sorted", "random", "one_id", "hub"])
def test_segment_partition_emulation_matches_plain(rng, ids_kind):
    n, e = 300, 20_011
    w = rng.uniform(0, 1, e).astype(np.float32)
    ids = rng.integers(-1, n + 1, e).astype(np.int32)
    if ids_kind == "sorted":
        ids = np.sort(ids)
    elif ids_kind == "one_id":
        ids[:] = 7
    elif ids_kind == "hub":
        ids[rng.permutation(e)[:e // 2]] = 3
    ref = sc.segment_sum_scalar_plain(torch.from_numpy(w),
                                      torch.from_numpy(ids), n).numpy()
    got = _emulate_segment_sum(w, ids, n, sc.segment_plan(n, e))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

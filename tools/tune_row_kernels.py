#!/usr/bin/env python3
"""Time variants of the port's row kernels on one NVIDIA card.

    python3 tools/tune_row_kernels.py [--kernels k1,k2,k7,k8,k8t]

K1 (``csrc/scatter.cu``) and K2 (``csrc/segment_sum.cu``) take their grid
from the wrapper's plan, so their variants are other plans passed to the
built library, timed by the profiler's device time on ``chip_smoke.py``'s
``row_cases`` (sampled receivers at q=200k, F=256 and 41; E=1M
receiver-sorted and unsorted senders; K2 at E=1M sorted and q=200k
sampled):

  * K1: the slab route at W=16 (the plan) with the chunks the plan picks,
    half and twice as many; at W=8; the direct route with float4 atomics
    (the plan's route above a slab of one sector); and builds with one
    constant changed (K1_BUILDS): 768 or 512 threads per slab block, 4 or 8 loads in flight per lane, and the direct
    route with scalar atomics (rows.cuh's float4 atomic split into four);
  * K2: items per block {2048, 4096 (the plan's floor), 8192, 16384}.

K7 and K8 variants are built from the checkout's sources with small text
patches, under ``build/tune/``, and timed with CUDA events on the bench
partition of ``chip_smoke.py`` (N=2048, E=1M, receiver-sorted):

  * K7, E=1M, F=256 bf16, band = required_band: items per warp
    {64, 128, 256} x the atomics of runs that cross a warp's range
    {"float4" (the source: 16-byte atomics), "scalar" (four 4-byte atomics
    per 16 bytes, the lane-strided pattern of the vector layout)};
  * K8's gather route, E=1M, bf16 x, weighted, F=256 and 41, the
    receiver-sorted list and its reversal: edges per warp {32, 64, 128} x
    the flush {"staged" (the source: through shared memory, coalesced
    scalar atomics), "float4", "scalar"}.

``--kernels k8t`` times K8's tile route on the same four cases, per kernel
from the profiler: the source at 1-4 parts per SM (other plans), and builds
with one piece of work taken out or changed (K8T_BUILDS: plain adds, or
integer atomics, in place of the weighted panel's f32 shared-memory
atomics, both giving wrong sums; no merging of a warp's duplicate places;
binning chunks of 1024 or 4096 edges (2048 in the source); float2 in
place of float4 flush atomics; no MMAs; no lo MMAs, or lo MMAs on every
tile; no flush atomics), with ptxas' remarks on each build.

Each variant is held against the plain version (max abs error printed).
Prints the card's name and power limit and one JSON line per variant,
and writes them to ``build/tune/results.json``.
"""
import argparse
import ctypes
import importlib
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from sgs_gnn_tpu_torch.ops import _build, scatter as sc  # noqa: E402

sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
OUT = ROOT / "build" / "tune"

# rows.cuh: a float4 atomic as four scalar ones
SCALAR = ("atomicAdd(p, v);", "atomicAdd(&p->x, v.x); atomicAdd(&p->y, v.y); "
          "atomicAdd(&p->z, v.z); atomicAdd(&p->w, v.w);")
# spmm.cu: write_row's float4 atomics in place of the staged adds
UNSTAGED = ((r"sgs::add_row_staged<T, kVec>\(", "sgs::write_row<T, kVec>("),
            (r"stage\[warp\], feat", "true, feat"))


def variant(tag, source, const, value, patches=(), rows_patch=None):
    d = OUT / tag
    d.mkdir(parents=True)
    for h in _build.CSRC.glob("*.cuh"):
        text = h.read_text()
        if rows_patch and h.name == "rows.cuh":
            assert rows_patch[0] in text
            text = text.replace(*rows_patch)
        (d / h.name).write_text(text)
    text = (_build.CSRC / source).read_text()
    text, n = re.subn(rf"constexpr int {const} = \d+;",
                      f"constexpr int {const} = {value};", text)
    assert n == 1, const
    for pat, rep in patches:
        text, n = re.subn(pat, rep, text)
        assert n, pat
    (d / source).write_text(text)
    return d / source, d / "lib.so"


# spmm.cu's tile route built otherwise: (tag, constant, value, [(pattern,
# replacement)])
_PANEL_ADD = (r"atomicAdd\(cell, w\);")
K8T_BUILDS = (
    ("plain panel adds (wrong sums)", "kBatch", 4,
     [(_PANEL_ADD, "*cell += w;")]),
    ("int panel atomics (wrong sums)", "kBatch", 4,
     [(_PANEL_ADD, "atomicAdd(reinterpret_cast<int*>(cell), "
                   "static_cast<int>(code & 0xffff));")]),
    ("no peer merge", "kMatchPeers", 0, []),
    ("binning chunks of 1024 edges", "kBinPer", 4, []),
    ("binning chunks of 4096 edges", "kBinPer", 16, []),
    ("float2 flush", "kFlushV4", 0, []),
    ("no MMAs", "kBatch", 4, [(r"k < kTileK / 16; \+\+k\)", "k < 0; ++k)")]),
    ("no lo MMAs", "kBatch", 4, [(r"if \(use_lo\) \{", "if (false) {")]),
    ("lo MMAs always", "kBatch", 4, [(r"if \(use_lo\) \{", "if (true) {")]),
    ("no flush", "kBatch", 4,
     [(r"(flush_rows\(const float[^{]*\{)", r"\1\n  return;")]),
)
TILE_FUNCS = ("spmm_bin_count_kernel", "spmm_bin_scatter_kernel",
              "spmm_tile_kernel")


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _bind(lib, fn_name):
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.argtypes = _build._SIGNATURES[fn_name]
    fn.restype = ctypes.c_int
    return fn


# K1 built otherwise: (tag, scatter.cu constant, value, rows.cuh patch)
K1_BUILDS = (
    ("direct scalar atomics", "kDirectWarps", 8, SCALAR),
    ("slab W=16, 768 threads", "kSlabThreads", 768, None),
    ("slab W=16, 512 threads", "kSlabThreads", 512, None),
    ("slab W=16, unroll 4", "kSlabUnroll", 4, None),
    ("slab W=16, unroll 8", "kSlabUnroll", 8, None))


def k1_k2_variants(kernels, libs):
    """K1 and K2 under other plans, and K1 as built otherwise (``libs``:
    tag of K1_BUILDS -> library), on the main paths' ids; one JSON line per
    (variant, case)."""
    from sgs_gnn_tpu_torch import Graph
    from sgs_gnn_tpu_torch.data import degree_prior
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    x, ei, y, tr = chip_smoke.build_partition()
    n = chip_smoke.N_NODES
    g = Graph.build(x, ei, y, tr, ~tr, None, device="cuda",
                    prob=degree_prior(ei[0], ei[1], n), sort_by_receiver=True)
    k1_cases, k2_cases = chip_smoke.row_cases(torch, g, gen)
    keep = ("sampled receivers", "receiver-sorted E=1M",
            "unsorted senders E=1M")
    stream = torch.cuda.current_stream().cuda_stream
    sms = sc._sm_count(0)
    lib = _build.library()
    modes = torch.zeros(2, dtype=torch.int32, device=dev)
    rows = []

    def timed(fn, funcs):
        return chip_smoke.device_ms(torch, fn, funcs, iters=10)[0]
    if "k1" in kernels:
        builds = {tag: _bind(lib_path, "sgs_scatter_add")
                  for tag, lib_path in libs.items()}
        for case, ids, f in k1_cases:
            if not case.startswith(keep):
                continue
            e = ids.shape[0]
            vals = torch.randn(e, f, generator=gen, device=dev).to(
                torch.bfloat16)
            ref = sc.scatter_add_plain(vals, ids, n)
            plan = sc.scatter_plan(n, f, 2, e, sms)
            direct = sc.ScatterPlan("direct", 256, -(-f // 256), 256,
                                    -(-e // 256), 0, 0)
            variants = [("slab W=16 (plan)", plan, lib.sgs_scatter_add)]
            variants += [(tag, direct if tag.startswith("direct") else plan,
                          fn) for tag, fn in builds.items()]
            for mult, tag in ((0.5, "half"), (2, "twice")):
                chunks = max(1, int(plan.chunks * mult))
                chunk = -(-e // chunks)
                sub = -(-chunk // -(-chunk // plan.sub_items))
                variants.append((f"slab W=16, chunks x{mult} ({tag})",
                                 plan._replace(
                                     chunk_items=chunk, chunks=-(-e // chunk),
                                     sub_items=sub,
                                     smem_bytes=sc.slab_smem(n, 16, sub)),
                                 lib.sgs_scatter_add))
            sub8 = min(plan.sub_items, 8192)     # two W=8 blocks per SM
            chunks8 = min(2 * sms // -(-f // 8), -(-e // 4096))
            variants.append(("slab W=8", sc.ScatterPlan(
                "slab", 8, -(-f // 8), -(-e // chunks8), chunks8, sub8,
                sc.slab_smem(n, 8, sub8)), lib.sgs_scatter_add))
            variants.append(("direct float4 atomics", direct,
                             lib.sgs_scatter_add))
            for tag, p, fn in variants:
                out = torch.zeros(n, f, device=dev)

                def run(fn=fn, p=p, out=out):
                    out.zero_()
                    err = fn(vals.data_ptr(), 1, ids.data_ptr(),
                             out.data_ptr(), e, f, n,
                             int(p.route == "direct"), p.col_tile,
                             p.chunk_items, p.sub_items, p.smem_bytes,
                             modes.data_ptr(), stream)
                    assert err == 0, (tag, err)
                run()
                row = dict(kernel="K1", case=case, variant=tag,
                           grid=[p.col_tiles, p.chunks],
                           device_ms=timed(run, ("scatter_slab_kernel",
                                                 "scatter_direct_kernel")),
                           max_abs_err=float((out - ref).abs().max()))
                rows.append(row)
                print(json.dumps(row), flush=True)
    if "k2" in kernels:
        for case, ids in k2_cases:
            if case.startswith("sorted"):
                continue
            e = ids.shape[0]
            w = torch.rand(e, generator=gen, device=dev)
            ref = sc.segment_sum_scalar_plain(w, ids, n)
            for items in (2048, 4096, 8192, 16384):
                out = torch.zeros(n, device=dev)

                def run(items=items, out=out):
                    out.zero_()
                    err = lib.sgs_segment_sum_scalar(
                        w.data_ptr(), ids.data_ptr(), out.data_ptr(), e, n,
                        items, stream)
                    assert err == 0, err
                run()
                row = dict(kernel="K2", case=case,
                           variant=f"items per block {items}",
                           blocks=-(-e // items),
                           device_ms=timed(run, ("segment_sum_kernel",)),
                           max_abs_err=float((out - ref).abs().max()))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def k8_tile_variants(senders, receivers, w, xs, builds, stream):
    """K8's tile route under other part counts and as built otherwise
    (``builds``: (tag, bound entry point)) on the bench partition's edges,
    both orders, F=256 and 41: device ms per kernel, one JSON line each."""
    n, e = chip_smoke.N_NODES, chip_smoke.N_EDGES
    dev = senders.device
    lib = _build.library()
    rows = []
    for case, s, r in (("sorted", senders, receivers),
                       ("reversed", receivers, senders)):
        for f, x in xs.items():
            plan = sp.spmm_plan(n, f, e, 2, sc._sm_count(0))
            scratch = torch.empty(sp.scratch_ints(plan, e), dtype=torch.int32,
                                  device=dev)
            ref = sp.spmm_fused_plain(s, r, w, x, n)
            per_sm = plan.parts * plan.slices / sc._sm_count(0)
            variants = [(f"parts per SM {k}" + (" (plan)" if k == per_sm
                                                else ""),
                         max(1, int(plan.parts * k / per_sm)),
                         lib.sgs_spmm_fused) for k in (1, 2, 3, 4)]
            variants += [(tag, plan.parts, fn) for tag, fn in builds]
            for tag, parts, fn in variants:
                out = torch.zeros(n, f, device=dev)

                def run(fn=fn, parts=parts, out=out):
                    out.zero_()
                    err = fn(s.data_ptr(), r.data_ptr(), w.data_ptr(),
                             x.data_ptr(), 1, out.data_ptr(), e, n, f,
                             plan.width, parts, scratch.data_ptr(), stream)
                    assert err == 0, (tag, err)
                run()
                total, by_name = chip_smoke.device_ms(torch, run, TILE_FUNCS,
                                                      iters=10)
                row = dict(kernel="K8 tiles", case=f"E=1M F={f} {case}",
                           variant=tag, parts=parts, device_ms=total,
                           by_kernel=by_name,
                           max_abs_err=float((out - ref).abs().max()))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="k1,k2,k7,k8")
    kernels = ap.parse_args().kernels.split(",")
    if not torch.cuda.is_available():
        print("tune_row_kernels: no CUDA card", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    if "k1" in kernels:
        for i, (tag, const, value, patch) in enumerate(K1_BUILDS):
            jobs.append((tag, "sgs_scatter_add") + variant(
                f"k1_{i}", "scatter.cu", const, value, rows_patch=patch))
    for items, mode in itertools.product((64, 128, 256), ("float4", "scalar")):
        if "k7" not in kernels:
            break
        jobs.append((f"k7 items={items} atomics={mode}",
                     "sgs_scatter_add_sorted") + variant(
            f"k7_{items}_{mode}", "scatter_sorted.cu", "kItemsPerWarp", items,
            rows_patch=SCALAR if mode == "scalar" else None))
    for i, (tag, const, value, patches) in enumerate(K8T_BUILDS):
        if "k8t" not in kernels:
            break
        jobs.append((f"k8 tiles: {tag}", "sgs_spmm_fused")
                    + variant(f"k8t_{i}", "spmm.cu", const, value, patches))
    for edges, mode in itertools.product((32, 64, 128),
                                         ("staged", "float4", "scalar")):
        if "k8" not in kernels:
            break
        jobs.append((f"k8 edges={edges} flush={mode}", "sgs_spmm_fused")
                    + variant(f"k8_{edges}_{mode}", "spmm.cu",
                              "kEdgesPerWarp", edges,
                              () if mode == "staged" else UNSTAGED,
                              SCALAR if mode == "scalar" else None))
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", str(src),
                               "-o", str(lib)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _, _, src, lib in jobs]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("a variant did not build:\n" + "\n".join(logs))
    for (tag, _, _, _), log in zip(jobs, logs):
        # ptxas' remarks (a serialized wgmma pipeline, say) per variant
        remarks = sorted({m for m in re.findall(r"\((C\d{4})\)", log)})
        print(json.dumps({"variant": tag, "ptxas_remarks": remarks}),
              flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    results = k1_k2_variants(kernels, {
        tag: lib for tag, fn, _, lib in jobs if fn == "sgs_scatter_add"})
    jobs = [j for j in jobs if j[1] != "sgs_scatter_add"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _, edge_index, _, _ = chip_smoke.build_partition()
    order = np.argsort(edge_index[1], kind="stable")
    s_np, r_np = edge_index[0][order], edge_index[1][order]
    n, e = chip_smoke.N_NODES, chip_smoke.N_EDGES
    senders = torch.from_numpy(np.ascontiguousarray(s_np)).to(dev)
    receivers = torch.from_numpy(np.ascontiguousarray(r_np)).to(dev)
    band, n_pad = sc._band_geometry(n, sc.required_band(r_np), 1024)
    vals = torch.randn(e, 256, generator=gen, device=dev).to(torch.bfloat16)
    ref7 = sc.scatter_add_sorted_plain(vals, receivers, n, band)
    w = torch.rand(e, generator=gen, device=dev)
    xs = {f: torch.randn(n, f, generator=gen, device=dev).to(torch.bfloat16)
          for f in (256, 41)}
    stream = torch.cuda.current_stream().cuda_stream
    if "k8t" in kernels:
        tiles = [(tag, _bind(lib, fn_name)) for tag, fn_name, _, lib in jobs
                 if tag.startswith("k8 tiles")]
        results += k8_tile_variants(senders, receivers, w, xs, tiles, stream)
        jobs = [j for j in jobs if not j[0].startswith("k8 tiles")]
    for tag, fn_name, _, lib in jobs:
        fn = _bind(lib, fn_name)
        row = dict(variant=tag)
        if fn_name == "sgs_scatter_add_sorted":
            out = torch.zeros(n, 256, device=dev)

            def run():
                out.zero_()
                fn(vals.data_ptr(), 1, receivers.data_ptr(), out.data_ptr(),
                   e, 256, n, band, n_pad, 1024, stream)
            run()
            row.update(case=f"E=1M F=256 bf16 band={band}", ms=cuda_ms(run),
                       max_abs_err=float((out - ref7).abs().max()))
        else:
            for case, s, r in (("sorted", senders, receivers),
                               ("reversed", receivers, senders)):
                for f, x in xs.items():
                    out = torch.zeros(n, f, device=dev)

                    def run():
                        out.zero_()
                        fn(s.data_ptr(), r.data_ptr(), w.data_ptr(),
                           x.data_ptr(), 1, out.data_ptr(), e, n, f, 0, 0,
                           None, stream)
                    run()
                    ref = sp.spmm_fused_plain(s, r, w, x, n)
                    row[f"{case} F={f} ms"] = cuda_ms(run)
                    row[f"{case} F={f} max_abs_err"] = float(
                        (out - ref).abs().max())
        results.append(row)
        print(json.dumps(row), flush=True)
    (OUT / "results.json").write_text(
        json.dumps(dict(card=smi.stdout.strip(), variants=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time variants of the port's two row kernels on one NVIDIA card.

    python3 tools/tune_row_kernels.py

Builds variants of ``sgs_gnn_tpu_torch/csrc/scatter_sorted.cu`` (K7) and
``spmm.cu`` (K8) from the checkout's sources with small text patches, under
``build/tune/``, and times each with CUDA events on the bench partition of
``chip_smoke.py`` (N=2048, E=1M, receiver-sorted):

  * K7, E=1M, F=256 bf16, band = required_band: items per warp
    {64, 128, 256} x the atomics of runs that cross a warp's range
    {"float4" (the source: 16-byte atomics), "scalar" (four 4-byte atomics
    per 16 bytes, the lane-strided pattern of the vector layout)};
  * K8, E=1M, bf16 x, weighted, F=256 and 41, the receiver-sorted list and
    its reversal: edges per warp {32, 64, 128} x the flush {"staged" (the
    source: through shared memory, coalesced scalar atomics), "float4",
    "scalar"}.

Each variant is held against the plain version (max abs error printed).
Prints the card's name and power limit and one JSON line per variant,
and writes them to ``build/tune/results.json``.
"""
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


def main():
    if not torch.cuda.is_available():
        print("tune_row_kernels: no CUDA card", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for items, mode in itertools.product((64, 128, 256), ("float4", "scalar")):
        jobs.append((f"k7 items={items} atomics={mode}",
                     "sgs_scatter_add_sorted") + variant(
            f"k7_{items}_{mode}", "scatter_sorted.cu", "kItemsPerWarp", items,
            rows_patch=SCALAR if mode == "scalar" else None))
    for edges, mode in itertools.product((32, 64, 128),
                                         ("staged", "float4", "scalar")):
        jobs.append((f"k8 edges={edges} flush={mode}", "sgs_spmm_fused")
                    + variant(f"k8_{edges}_{mode}", "spmm.cu",
                              "kEdgesPerWarp", edges,
                              () if mode == "staged" else UNSTAGED,
                              SCALAR if mode == "scalar" else None))
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = [subprocess.Popen([nvcc, *flags, "-shared", str(src), "-o",
                               str(lib)]) for _, _, src, lib in jobs]
    if any(p.wait() for p in procs):
        raise RuntimeError("a variant did not build")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
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
    results = []
    for tag, fn_name, _, lib in jobs:
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes = _build._SIGNATURES[fn_name]
        fn.restype = ctypes.c_int
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
                           x.data_ptr(), 1, out.data_ptr(), e, n, f, stream)
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

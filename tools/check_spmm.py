#!/usr/bin/env python3
"""Build the fused SpMM (K8, ``csrc/spmm.cu``) and check it on one NVIDIA
card: the first call to make after changing the kernel, before
``chip_smoke.py`` or the card tests.

    python3 tools/check_spmm.py

Prints the build time and ptxas' lines for K8's kernels (registers,
spills, remarks), then one JSON line per case (route, plan, maximum error
against ``spmm_fused_plain`` and the excess over the tolerance 1e-5 *
sum|w x| per row + 1e-6) on uniform random edges: E=1M at F=256 and 41 in
both orders, small and ragged N, F=600 in slices, f32 x (the gather
route), endpoints out of range, one pair repeated 300 and 3000 times, an
empty receiver block. Then, at E=1M, N=2048, the device time of each of
K8's kernels (torch.profiler) and CUDA-event ms beside torch.sparse.mm's.
Exits 1 if a case is off its plain version.
"""
import importlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sgs_gnn_tpu_torch.ops import _build  # noqa: E402

sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
DEV = torch.device("cuda")


def ptxas_lines(lib):
    cur = False
    for line in Path(f"{lib}.log").read_text().splitlines():
        if "spmm" in line and ("Compiling entry" in line
                               or "Function properties" in line):
            print(line.strip()[:200])
            cur = True
        elif cur and any(k in line for k in ("Used", "spill", "arning",
                                             "C75")):
            print("   ", line.strip()[:250])
            cur = "Used" not in line


def case(gen, n, e, f, weighted, order, dtype=torch.bfloat16, lo=0,
         hi=None, dup=0, empty_block=False):
    hi = n if hi is None else hi
    s = torch.randint(lo, hi, (e,), generator=gen, device=DEV,
                      dtype=torch.int32)
    r = torch.randint(0, n, (e,), generator=gen, device=DEV,
                      dtype=torch.int32).sort().values
    if dup:
        s[:dup], r[:dup] = 5, 7
    if empty_block:
        r = torch.where((r >= 64) & (r < 128), r + 64, r)
    if order == "reversed":
        s, r = r, s
    w = (torch.rand(e, generator=gen, device=DEV) if weighted
         else torch.ones(e, device=DEV))
    x = torch.randn(n, f, generator=gen, device=DEV).to(dtype)
    plan = sp.spmm_plan(n, f, e, x.element_size())
    out = sp._spmm_fused(s, r, w, x, n)
    torch.cuda.synchronize()
    ref = sp.spmm_fused_plain(s, r, w, x, n)
    tol = 1e-5 * sp.spmm_fused_plain(s, r, w, x.abs(), n) + 1e-6
    err = (out - ref).abs()
    ok = bool((err <= tol).all())
    print(json.dumps(dict(n=n, e=e, f=f, weighted=weighted, order=order,
                          dtype=str(dtype), dup=dup, route=plan.route,
                          width=plan.width, parts=plan.parts, ok=ok,
                          max_err=float(err.max()),
                          max_excess=float((err - tol).max()))), flush=True)
    return s, r, w, x, ok


def events_ms(fn, iters=20):
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
        print("check_spmm: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.time()
    lib = _build.build()
    print("build_s", time.time() - t0, flush=True)
    ptxas_lines(lib)
    _build.library()
    gen = torch.Generator(device=DEV).manual_seed(0)
    ok = True
    for args, kw in [((2048, 1_000_000, 256, False, "sorted"), {}),
                     ((2048, 1_000_000, 256, True, "reversed"), {}),
                     ((2048, 1_000_000, 41, True, "sorted"), {}),
                     ((2048, 1_000_000, 41, False, "reversed"), {}),
                     ((300, 20_000, 41, True, "sorted"), {}),
                     ((130, 5000, 64, False, "reversed"), {}),
                     ((1000, 100_000, 100, True, "sorted"), {}),
                     ((2048, 200_000, 600, True, "sorted"), {}),
                     ((2048, 1_000_000, 256, False, "sorted"),
                      dict(dtype=torch.float32)),
                     ((2048, 300_000, 256, True, "sorted"),
                      dict(lo=-3, hi=2051)),
                     ((2048, 300_000, 64, False, "sorted"), dict(dup=300)),
                     ((2048, 300_000, 64, True, "sorted"), dict(dup=3000)),
                     ((2048, 300_000, 256, True, "reversed"),
                      dict(empty_block=True)),
                     ((64, 5000, 256, True, "sorted"), {}),
                     ((70, 50_000, 40, True, "reversed"), {})]:
        ok &= case(gen, *args, **kw)[-1]
    from torch.profiler import ProfilerActivity, profile
    for f in (256, 41):
        for order in ("sorted", "reversed"):
            s, r, w, x, good = case(gen, 2048, 1_000_000, f, True, order)
            ok &= good
            key = torch.argsort(r, stable=True)
            crow = torch.zeros(2049, dtype=torch.int64, device=DEV)
            crow[1:] = torch.cumsum(torch.bincount(r.long(), minlength=2048),
                                    0)
            a = torch.sparse_csr_tensor(crow, s.long()[key],
                                        w.to(x.dtype).float()[key],
                                        (2048, 2048))
            xf = x.float()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    sp._spmm_fused(s, r, w, x, 2048)
                torch.cuda.synchronize()
            by_name = {}
            for ev in prof.events():
                if ev.device_type.name == "CUDA":
                    by_name[ev.name[:60]] = by_name.get(ev.name[:60], 0.0) \
                        + ev.time_range.elapsed_us() / 5e3
            print(json.dumps(dict(
                f=f, order=order,
                ms=events_ms(lambda: sp._spmm_fused(s, r, w, x, 2048)),
                library_ms=events_ms(lambda: torch.sparse.mm(a, xf)),
                device_ms_by_kernel=by_name)), flush=True)
    print("all cases within tolerance:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the tensor-core head (bf16 K3 and K6, csrc/head_mma.cuh; bf16 K5,
csrc/head_bwd_mma.cuh) and variants of it that each take one piece of its
work away, on one NVIDIA card.

    python3 tools/tune_head_mma.py [--variants a,b] [--alt TAG=PATH ...]

Builds ``sgs_gnn_tpu_torch/csrc/score_sampled.cu`` and ``score_tiles.cu``
with text patches of ``head_mma.cuh`` and ``head_bwd_mma.cuh`` under
``build/tune_head/`` and times each with CUDA events at the bench
partition's shapes (N=2048, F=K=256, bf16; the kernels alone: W1 packed
and h's rows made once, outside the timed loop; K5 also per kernel from
torch.profiler):

  * source            the kernels as they are;
  * no_setmaxnreg     without the register hand-over to the consumers
                      (ptxas then caps a thread at 168 registers);
  * weights_once      every forward ring stage loaded once: later chunks
                      reuse stale weights (wrong results; the weight
                      stream's cost; K5's dz1 pass streams the same way);
  * no_gathers        the row gathers read nothing (zero rows; wrong
                      results: the gathers' cost; in K5 also the dh
                      pass's reads of hu / hv);
  * no_mma            the wgmma instructions taken out (the rest's cost);
  * no_hash           the epilogues without the dropout test (every unit
                      kept: wrong results with dropout; the hash's cost);
  * no_dh_atomics     K5's dh pass without its dh_v atomics and without
                      the run merge of dh_u and its atomics;
  * --alt TAG=PATH    another head_mma.cuh (an earlier version, say),
                      built and timed beside the source.

Cases: K3 over q=E=1M edges without and with dropout 0.3, K3 on q=200k
sorted senders with dropout 0.3 (the banded row), K6 over every tile slot
with dropout 0.3, K5 on the banded case's edges and mask. Each variant's
error against the plain version is printed beside its time (K5: the
largest over its six outputs of max error / max|plain|). Prints the card's
name and power limit and one JSON line per variant; writes them to
``build/tune_head/results.json``.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from sgs_gnn_tpu_torch.ops import _build  # noqa: E402
from sgs_gnn_tpu_torch.ops import score_sampled as ss  # noqa: E402
from sgs_gnn_tpu_torch.ops import score_tiles as st  # noqa: E402
from sgs_gnn_tpu_torch.ops.dropout import HeadDropout  # noqa: E402

OUT = ROOT / "build" / "tune_head"
FWD, BWD = "head_mma.cuh", "head_bwd_mma.cuh"
SETMAXNREG = (r'asm volatile\("setmaxnreg[^)]*\)\);', "")
# tag -> ((header, pattern, replacement), ...)
PATCHES = {
    "source": (),
    "no_setmaxnreg": ((FWD,) + SETMAXNREG, (BWD,) + SETMAXNREG),
    "weights_once": ((FWD, r"mbar_expect_tx\(full0 \+ 8 \* s, kChunkBytes\);",
                      "if (g >= kStages) { mbar_arrive(full0 + 8 * s); "
                      "continue; }\n"
                      "          mbar_expect_tx(full0 + 8 * s, "
                      "kChunkBytes);"),),
    "no_gathers": ((FWD, r"const bool in = col < pitch;",
                    "const bool in = false;"),
                   (BWD, r"const bool in = col < pitch;",
                    "const bool in = false;"),
                   (BWD, r"if \(id < 0 \|\| col >= feat\)", "if (true)")),
    "no_mma": ((FWD, r"wgmma_m64n256k16\(acc,[^;]*;", ";"),
               (BWD, r"wgmma_m64n128k16\(d[a-z]+,[^;]*;", ";"),
               (BWD, r"wgmma_m64n256k16<1, 1>\(acc,[^;]*;", ";")),
    "no_hash": ((FWD, r"if \(thresh == 0u\)\n(\s+)tile_logits<kNoDrop>",
                 r"if (true)\n\1tile_logits<kNoDrop>"),
                (BWD, r"if \(thresh == 0u\)\n(\s+)tile_(logits|dz1)<kNoDrop>",
                 r"if (true)\n\1tile_\2<kNoDrop>")),
    "no_dh_atomics": ((BWD, r"if \(rr\[r\] >= 0 && col < feat\)",
                       "if (false)"),
                      (BWD, r"if \(col < feat\) \{\n(\s+)int cur = -1;",
                       r"if (false) {\n\1int cur = -1;")),
}


def variant(tag, patches, header=None):
    d = OUT / tag
    d.mkdir(parents=True)
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (d / src.name).write_text(src.read_text())
    if header:
        (d / FWD).write_text(Path(header).read_text())
    for name, pat, rep in patches:
        text, n = re.subn(pat, rep, (d / name).read_text())
        assert n, (tag, name, pat)
        (d / name).write_text(text)
    return [d / "score_sampled.cu", d / "score_tiles.cu"], d / "lib.so"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(PATCHES),
                    help="comma-separated patch variants to build")
    ap.add_argument("--alt", action="append", default=[],
                    metavar="TAG=PATH", help="also build head_mma.cuh from "
                    "PATH under the name TAG")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_head_mma: no CUDA card", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = [(tag,) + tuple(variant(tag, PATCHES[tag]))
            for tag in args.variants.split(",")]
    for alt in args.alt:
        tag, path = alt.split("=", 1)
        jobs.append((tag,) + tuple(variant(tag, (), path)))
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = [subprocess.Popen([nvcc, *flags, "-shared", *map(str, srcs),
                               "-o", str(lib)]) for _, srcs, lib in jobs]
    if any(p.wait() for p in procs):
        raise RuntimeError("a variant did not build")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from sgs_gnn_tpu_torch import Graph
    x, edge_index, y, train = chip_smoke.build_partition()
    g = Graph.build(x, edge_index, y, train, ~train, None, device="cuda",
                    sort_by_receiver=True, tile_index=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    n, f = chip_smoke.N_NODES, chip_smoke.NHID
    h = torch.randn(n, f, generator=gen, device=dev).relu().to(torch.bfloat16)
    fc1 = torch.randn(2 * f, f, generator=gen, device=dev) / (2 * f) ** 0.5
    b1 = torch.randn(f, generator=gen, device=dev) * 0.1
    fc2 = torch.randn(f, 1, generator=gen, device=dev) / f ** 0.5
    b2 = torch.randn(1, generator=gen, device=dev) * 0.1
    w1a, w1b, b1f, w2f, b2f = ss.split_head(h, fc1, b1, fc2, b2)
    hk, _, pitch, wpack = ss.kernel_operands(h, w1a, w1b)
    sub = torch.randperm(chip_smoke.N_EDGES, generator=gen,
                         device=dev)[:chip_smoke.Q].sort().values
    tile = (g.tile_ls, g.tile_lr, g.tile_su, g.tile_rv)
    ep = g.tile_ls.shape[0]
    cases = []
    for name, s, r, rate in (
            ("K3 q=E=1M", g.senders, g.receivers, 0.0),
            ("K3 q=E=1M dropout 0.3", g.senders, g.receivers, 0.3),
            ("K3 banded q=200k sorted senders dropout 0.3", g.senders[sub],
             g.receivers[sub], 0.3)):
        drop = HeadDropout.make(rate, 4242, dev)
        ref = ss.score_head_plain(h, w1a, w1b, b1f, w2f, b2f, s, r, drop)
        cases.append((name, "sgs_score_head_fwd", ref, lambda fn, out, s=s,
                       r=r, d=drop: fn(
            hk.data_ptr(), 1, pitch, w1a.data_ptr(), w1b.data_ptr(),
            wpack.data_ptr(), b1f.data_ptr(), w2f.data_ptr(), b2f.data_ptr(),
            s.data_ptr(), r.data_ptr(), d.seed.data_ptr(), d.thresh, d.scale,
            out.data_ptr(), s.shape[0], n, f, f,
            torch.cuda.current_stream().cuda_stream)))
    drop = HeadDropout.make(0.3, 4242, dev)
    ref = st.score_head_tiles_plain(h, w1a, w1b, b1f, w2f, b2f, *tile,
                                    g.tile_t, g.tile_b, drop)
    cases.append((f"K6 Ep={ep} dropout 0.3", "sgs_score_head_tiles", ref,
                  lambda fn, out: fn(
        hk.data_ptr(), 1, pitch, w1a.data_ptr(), w1b.data_ptr(),
        wpack.data_ptr(), b1f.data_ptr(), w2f.data_ptr(), b2f.data_ptr(),
        *(t.data_ptr() for t in tile), g.tile_t, g.tile_b,
        drop.seed.data_ptr(), drop.thresh, drop.scale, out.data_ptr(), ep,
        n, f, f, torch.cuda.current_stream().cuda_stream)))
    # K5 on the banded case's edges and mask, its sorted receivers first as
    # the wrapper's swap puts them (two_pass; the outputs accumulate over
    # the timed calls, the error is taken from the first call)
    s5, r5 = g.receivers[sub], g.senders[sub]
    q5 = s5.shape[0]
    dp5 = torch.randn(q5, generator=gen, device=dev)
    ref5 = ss.score_head_bwd_plain(h, w1a, w1b, b1f, w2f, b2f, s5, r5, dp5,
                                   drop)
    _, _, _, _, wpack_t, dz1 = ss.bwd_operands(h, w1a, w1b, q5)
    cases.append(("K5 q=200k sorted first side dropout 0.3",
                  "sgs_score_head_bwd", ref5, lambda fn, out: fn(
        hk.data_ptr(), 1, pitch, w1a.data_ptr(), w1b.data_ptr(),
        wpack.data_ptr(), wpack_t.data_ptr(), b1f.data_ptr(), w2f.data_ptr(),
        b2f.data_ptr(), s5.data_ptr(), r5.data_ptr(), dp5.data_ptr(),
        drop.seed.data_ptr(), drop.thresh, drop.scale, dz1.data_ptr(),
        *(o.data_ptr() for o in out), q5, n, f, f,
        torch.cuda.current_stream().cuda_stream)))

    results = []
    for tag, _, lib in jobs:
        so = ctypes.CDLL(str(lib))
        row = dict(variant=tag)
        for name, fn_name, ref, call in cases:
            fn = getattr(so, fn_name)
            fn.argtypes = _build._SIGNATURES[fn_name]
            fn.restype = ctypes.c_int
            k5 = isinstance(ref, tuple)
            out = (tuple(torch.zeros_like(a) for a in ref) if k5
                   else torch.empty_like(ref))
            err = call(fn, out)
            assert err == 0, (tag, name, err)
            torch.cuda.synchronize()
            if k5:
                row[f"{name} max_err_over_max_ref"] = max(
                    float((a - b).abs().max() / b.abs().max().clamp(
                        min=1e-30)) for a, b in zip(out, ref))
                _, row[f"{name} device_ms_by_kernel"] = chip_smoke.device_ms(
                    torch, lambda: call(fn, out), chip_smoke.HEAD_BWD_KERNELS)
            else:
                row[f"{name} max_abs_err"] = float((out - ref).abs().max())
            row[f"{name} ms"] = chip_smoke.cuda_ms(
                torch, lambda: call(fn, out), iters=10)
        results.append(row)
        print(json.dumps(row), flush=True)
    (OUT / "results.json").write_text(
        json.dumps(dict(card=smi.stdout.strip(), variants=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

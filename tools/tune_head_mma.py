#!/usr/bin/env python3
"""Time the tensor-core forward head (bf16 K3 and K6) and variants of it
that each take one piece of its work away, on one NVIDIA card.

    python3 tools/tune_head_mma.py [--variants a,b] [--alt TAG=PATH ...]

Builds ``sgs_gnn_tpu_torch/csrc/score_sampled.cu`` and ``score_tiles.cu``
with text patches of ``head_mma.cuh`` under ``build/tune_head/`` and
times each with CUDA events at the bench partition's shapes (N=2048,
F=K=256, bf16; the kernel alone: W1 packed and h's rows made once, outside
the timed loop):

  * source            the kernel as it is;
  * no_setmaxnreg     without the register hand-over to the consumers
                      (ptxas then caps a thread at 168 registers);
  * weights_once      every ring stage loaded once: later chunks reuse
                      stale weights (wrong results; the weight stream's cost);
  * no_gathers        the row gathers read nothing (zero rows; wrong
                      results: the gathers' cost);
  * no_mma            the wgmma instructions taken out (the rest's cost);
  * no_hash           the epilogue without the dropout test (every unit
                      kept: wrong results with dropout; the hash's cost);
  * --alt TAG=PATH    another head_mma.cuh (an earlier version, say),
                      built and timed beside the source.

Cases: K3 over q=E=1M edges without and with dropout 0.3, K3 on q=200k
sorted senders with dropout 0.3 (the banded row), K6 over every tile slot
with dropout 0.3. Each variant's max abs error against the plain version
is printed beside its time. Prints the card's name and power limit and one
JSON line per variant; writes them to ``build/tune_head/results.json``.
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
PATCHES = {
    "source": (),
    "no_setmaxnreg": ((r'asm volatile\("setmaxnreg[^)]*\)\);', ""),),
    "weights_once": ((r"mbar_expect_tx\(full0 \+ 8 \* s, kChunkBytes\);",
                      "if (g >= kStages) { mbar_arrive(full0 + 8 * s); "
                      "continue; }\n"
                      "          mbar_expect_tx(full0 + 8 * s, "
                      "kChunkBytes);"),),
    "no_gathers": ((r"const bool in = col < pitch;",
                    "const bool in = false;"),),
    "no_mma": ((r"wgmma_m64n256k16\(acc,[^;]*;", ";"),),
    "no_hash": ((r"if \(thresh == 0u\)\n(\s+)tile_logits<kNoDrop>",
                 r"if (true)\n\1tile_logits<kNoDrop>"),),
}


def variant(tag, patches, header=None):
    d = OUT / tag
    d.mkdir(parents=True)
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (d / src.name).write_text(src.read_text())
    text = Path(header or d / "head_mma.cuh").read_text()
    for pat, rep in patches:
        text, n = re.subn(pat, rep, text)
        assert n, (tag, pat)
    (d / "head_mma.cuh").write_text(text)
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

    results = []
    for tag, _, lib in jobs:
        so = ctypes.CDLL(str(lib))
        row = dict(variant=tag)
        for name, fn_name, ref, call in cases:
            fn = getattr(so, fn_name)
            fn.argtypes = _build._SIGNATURES[fn_name]
            fn.restype = ctypes.c_int
            out = torch.empty_like(ref)
            err = call(fn, out)
            assert err == 0, (tag, name, err)
            torch.cuda.synchronize()
            row[f"{name} ms"] = chip_smoke.cuda_ms(
                torch, lambda: call(fn, out), iters=10)
            row[f"{name} max_abs_err"] = float((out - ref).abs().max())
        results.append(row)
        print(json.dumps(row), flush=True)
    (OUT / "results.json").write_text(
        json.dumps(dict(card=smi.stdout.strip(), variants=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once, on one card, and print its result
as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` measures the window and reports the cell's end-to-end
metrics; ``--trace 1`` profiles a stretch of whole epochs (or requests)
and reports its per-layer metrics, with the program's own spans and
stamps on where one of them reads them. Both then compare what the
program produced with the plain reference and print each number beside
its limit.
Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# the port builds its kernels and partitioner into build/ in the checkout
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out


def forbidden_modules():
    from benchmark.harness import FORBIDDEN
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import compare, harness
    cell = harness.Cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    if args.trace and cell.reads_program():
        # the stamps are captured into the graphs: on before the set-up
        from sgs_gnn_tpu_torch.core import spans
        spans.reset()
        spans.enable(device_stamps=True)
    run = harness.Run(cell, args.seed, "cuda", t_start=T_START)
    run.setup()
    result = {"correct": False, "attempted": 0, "failed": 0}
    if args.trace:
        metrics = run.traced()
    else:
        metrics = run.window(args.seconds)
        metrics["setup_s"] = run.setup_s
    result["attempted"] = run.attempted
    run.release()
    if not args.trace:
        metrics["peak_mem_gib"] = run.peak / 2 ** 30
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]}
    result["metrics"] = {k: (v if isinstance(v, dict)
                             else {"value": v, "unit": units[k]})
                         for k, v in metrics.items()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": run.peak}
    if args.trace:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {
            "device_ops": run.trace.device_ops(),
            "idle_gaps": [[k, v] for k, v in sorted(
                run.trace.gaps.items(), key=lambda kv: -kv[1])[:10]]}
    result["device"] = device
    print(f"card: {card_line()}", flush=True)
    print(f"plan: {json.dumps(run.batch_plan)}", flush=True)
    numbers = run.check()
    ok, rows = compare.verdict(numbers, cell.limits)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded modules of {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result["correct"] = ok
    result["failed"] = sum(v > lim for _, v, lim in rows)
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v in numbers.items():
        if k not in cell.limits:
            print(f"read {k} {v!r} (not compared)", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Trace the port from inside: one benchmark cell run with ``core/spans``
on (host spans, counters and device stamps inside the CUDA graphs), or the
cost of that tracing. Needs a card: exits 2 without one.

    python3 tools/program_trace.py trace --workload <cell> --seed <n> [--check]
    python3 tools/program_trace.py cost --workload <cell> --seed <n> \\
        --seconds <s> [--turns off,on,on,off]

``trace`` turns the spans and stamps on before the cell's set-up (so the
captured graphs hold the stamps), profiles the cell's traced stretch
(``benchmark/traffic/<mix>.json``: whole epochs or a number of requests)
with ``torch.profiler`` as ``benchmark/trace.py`` does, and prints one JSON
line: the set-up's spans; the window's spans, counters and stamped
segments; the idle gaps labelled by the harness's spans and by the
program's (``spans.label_gaps``); the stamped device time of the train
graphs (every segment but ``between``) beside the profiler's device time of
the same replays; and the readings the per-layer metrics of this tracing
would take (``optimizer_ms.train`` ... ``setup_partition_s``; GIN's
``aggregate_ms`` and ``message_gib``, per trained step or request, from
the ``aggregate`` stamps and ``kernels.bytes.spmm.gather_k1``), and the
share of the window's GCN aggregations that took K8 (``spmm_k8_share``,
from ``kernels.routes.spmm.*``), K1's slab chunks per mode and the share
in "rows" mode (``k1_rows_share``, counted by the kernel) and the ordered
top-q draw's ties (``topq_ties``). With
``--check`` the run is then held to the plain reference as
``benchmark/run.py`` holds it, and ``correct`` is printed.

``cost`` runs the cell's measured window (``benchmark/run.py --trace 0``'s
end-to-end metric) in one process per turn, with the program's tracing
off or on (the profiler off in both), and prints each turn's metric,
``setup_s`` and, on, the stamps per step or request.
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
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRAIN_METRICS = ("optimizer_ms.train", "backbone_ms.train",
                 "scorer_ms.train", "host_idle_ms.train")
SERVE_METRICS = ("sample_ms.serve", "backbone_ms.serve",
                 "host_idle_ms.serve")


def _run(workload, seed, spans_on, t_start=None):
    """A set-up benchmark run of ``workload``, the program's tracing on
    before the set-up with ``spans_on``."""
    from benchmark import harness
    from sgs_gnn_tpu_torch.core import spans
    run = harness.Run(harness.Cell(workload), seed, "cuda", t_start=t_start)
    if spans_on:
        spans.reset()
        spans.enable(device_stamps=True)
    run.setup()
    return run


def _intervals_inside(busy, outer):
    """Microseconds of the merged ``busy`` intervals inside ``outer``."""
    total = 0.0
    for a, b in outer:
        for s, e in busy:
            total += max(0.0, min(b, e) - max(a, s))
    return total


def profiled(run):
    """The traced stretch under the profiler with the program's spans on;
    what it showed, in seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from benchmark import trace
    from sgs_gnn_tpu_torch.core import spans
    from sgs_gnn_tpu_torch.ops import sampling_ops
    from sgs_gnn_tpu_torch.ops import scatter as sc
    t = run.cell.traffic
    if t["loop"] == "train_epochs":
        fn = lambda: run._train_window(epochs=t["trace_epochs"])
    else:
        fn = lambda: run._serve_window(requests=t["trace_requests"])
    torch.cuda.synchronize()
    spans.reset()
    sc.reset_slab_chunk_modes()
    sampling_ops.reset_topq_ties()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.span(torch, "window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    program = spans.collect()
    k1_chunks = sc.slab_chunk_modes()
    topq_ties = sampling_ops.topq_ties()
    events = list(prof.events())
    prefixes = (trace.SPAN_PREFIX, spans.PREFIX)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    work = [e for e in dev if not e.name.startswith(prefixes)
            and "stamp_kernel" not in e.name]
    stamps = [e for e in dev if "stamp_kernel" in e.name]
    busy = trace._union((e.time_range.start, e.time_range.end)
                        for e in work)
    busy_s = sum(b - a for a, b in busy) / 1e6
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    win = [e for e in host if e.name == trace.SPAN_PREFIX + "window"]
    lo = min(e.time_range.start for e in win)
    hi = max(e.time_range.end for e in win)

    def labelled(prefix):
        return [(e.name[len(prefix):], e.time_range.start, e.time_range.end)
                for e in host if e.name.startswith(prefix)]
    kernels = {}
    for e in work:
        rec = kernels.setdefault(e.name[:120], [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e6
    replays = {}
    for kind in ("step", "eval", "serve"):
        ann = [(e.time_range.start, e.time_range.end) for e in dev
               if e.name == f"{spans.PREFIX}{kind}.replay"]
        if ann:
            replays[kind] = dict(
                replays=len(ann),
                extent_s=sum(b - a for a, b in ann) / 1e6,
                kernels_s=_intervals_inside(busy, trace._union(ann)) / 1e6)
    return dict(window_s=window_s, busy_s=busy_s,
                stamp_kernels=[len(stamps), sum(
                    e.time_range.elapsed_us() for e in stamps) / 1e6],
                gaps=spans.label_gaps(busy, labelled(trace.SPAN_PREFIX),
                                      lo, hi),
                program_gaps=spans.label_gaps(busy, labelled(spans.PREFIX),
                                              lo, hi),
                device_ops=[[k, v[1], v[0]] for k, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1][1])[:15]],
                replays=replays, program=program, k1_slab_chunks=k1_chunks,
                topq_ties=topq_ties)


def readings(run, tr, setup):
    """The per-layer readings of this tracing."""
    facts, seg = run.window_facts, tr["program"]["segments"]

    def seg_s(*names):
        return sum(seg.get(n, {"s": 0.0})["s"] for n in names)
    idle = sum(v for k, v in tr["program_gaps"].items() if k != "outside")
    out = {"setup_partition_s": setup["spans"].get(
        "data.partition", {}).get("total_s")}
    if run.cell.traffic["loop"] == "train_epochs":
        steps = facts["steps"]
        sampled = facts["epochs"] * run.plan.count(2)
        out["optimizer_ms.train"] = 1e3 * seg_s("step.optimizer") / steps
        out["backbone_ms.train"] = 1e3 * seg_s("step.backbone") / steps
        out["aggregate_ms.train"] = 1e3 * seg_s("step.aggregate") / steps
        if run.cell.mode == "learned":
            out["scorer_ms.train"] = 1e3 * seg_s(
                "step.scorer", "step.sampler") / sampled
        out["host_idle_ms.train"] = 1e3 * idle / facts["epochs"]
        stamped = sum(v["s"] for k, v in seg.items()
                      if k.startswith("step.") and k != "step.between")
        rep = tr["replays"].get("step", {})
        out["train_stamped_s"] = stamped
        out["train_replay_kernels_s"] = rep.get("kernels_s")
        out["train_replay_extent_s"] = rep.get("extent_s")
        out["stamps_per_step"] = sum(
            v["stamps"] for k, v in seg.items()
            if k.startswith("step.")) / steps
    else:
        n = facts["requests"]
        out["sample_ms.serve"] = 1e3 * seg_s("serve.sampler") / n
        out["backbone_ms.serve"] = 1e3 * seg_s("serve.backbone") / n
        out["aggregate_ms.serve"] = 1e3 * seg_s("serve.aggregate") / n
        out["host_idle_ms.serve"] = 1e3 * idle / n
        out["stamps_per_request"] = sum(
            v["stamps"] for k, v in seg.items()
            if k.startswith("serve.")) / n
    # the share of the window's GCN aggregations (spmm "auto") on K8
    counters = tr["program"]["counters"]
    k8, k1 = (counters.get(f"kernels.routes.spmm.{r}", 0)
              for r in ("k8_tiles", "gather_k1"))
    out["spmm_k8_share"] = k8 / (k8 + k1) if k8 + k1 else None
    per = facts.get("steps") or facts.get("requests")
    out["message_gib"] = counters.get(
        "kernels.bytes.spmm.gather_k1", 0) / 2 ** 30 / per
    # K1's slab chunks in "rows" mode (sorted ids), as the kernel counted
    chunks = tr["k1_slab_chunks"]
    total = sum(chunks.values())
    out["k1_rows_share"] = chunks["rows"] / total if total else None
    return out


def cmd_trace(args):
    import torch
    from benchmark import compare
    from sgs_gnn_tpu_torch.core import spans
    run = _run(args.workload, args.seed, True, T_START)
    torch.cuda.synchronize()
    setup = spans.collect()
    tr = profiled(run)
    result = dict(workload=args.workload, seed=args.seed,
                  card=torch.cuda.get_device_name(0), setup_s=run.setup_s,
                  setup=dict(spans=setup["spans"],
                             counters=setup["counters"]),
                  readings=readings(run, tr, setup),
                  window={k: v for k, v in tr.items() if k != "program"},
                  spans=tr["program"]["spans"],
                  counters=tr["program"]["counters"],
                  segments=tr["program"]["segments"],
                  facts=run.window_facts)
    spans.disable()
    if args.check:
        run.release()
        ok, rows = compare.verdict(run.check(), run.cell.limits)
        result["correct"] = ok
        result["check"] = {k: [v, lim] for k, v, lim in rows}
    print(json.dumps(result, default=str), flush=True)
    return 0


def cmd_window(args):
    import torch
    from sgs_gnn_tpu_torch.core import spans
    run = _run(args.workload, args.seed, args.spans, T_START)
    setup_s = run.setup_s
    spans.reset()
    metrics = run.window(args.seconds)
    torch.cuda.synchronize()
    out = dict(spans=args.spans, setup_s=setup_s, **metrics)
    if args.spans:
        seg = spans.collect()["segments"]
        facts = run.window_facts
        per = facts.get("steps") or facts.get("requests")
        out["stamps_per_step_or_request"] = sum(
            v["stamps"] for v in seg.values()) / per
    print(json.dumps(out), flush=True)
    return 0


def cmd_cost(args):
    turns = []
    for turn in args.turns.split(","):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "window",
             "--workload", args.workload, "--seed", str(args.seed),
             "--seconds", str(args.seconds), "--spans",
             str(int(turn == "on"))], capture_output=True, text=True,
            cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          turns=turns)), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("trace", "cost", "window"):
        p = sub.add_parser(name)
        p.add_argument("--workload", required=True)
        p.add_argument("--seed", type=int, required=True)
        if name != "trace":
            p.add_argument("--seconds", type=float, default=30.0)
    sub.choices["trace"].add_argument("--check", action="store_true")
    sub.choices["cost"].add_argument("--turns", default="off,on,on,off")
    sub.choices["window"].add_argument("--spans", type=int, choices=(0, 1),
                                       default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    return {"trace": cmd_trace, "cost": cmd_cost,
            "window": cmd_window}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

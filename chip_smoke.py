#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sgs_gnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   the card (name and power limit from nvidia-smi), the build of
              the CUDA kernels from the sources in this checkout.
  2. kernel   each kernel of the serving path against its plain PyTorch
              version on the card at the path's shapes: error against the
              stated tolerance, and times (CUDA events) of the kernel, the
              plain version and one PyTorch library call, beside the
              kernel's bound on an H100 SXM.
  3. serve    sparsify + predict (11 draws) at the bench partition's full
              width (N=2048, E=1M, 602 features, nhid 256, 41 classes,
              q=200k, bf16) with random weights from a seed; launch counts of
              that one run; outputs checked for shape and finiteness and
              against the same port run on the CPU in f32. One more call of
              each under torch.profiler (a ``profile`` line each): device
              time by kernel, device busy time and idle share.

Then a ``kernels`` line (every kernel: route, source, the TPU kernel it
replaces, launches, error and times) and, last, the ok line. Any failed
check raises and the script exits nonzero without the ok line; without a
card it exits 1 before doing anything.
"""
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

N_NODES, N_EDGES, FEAT, CLASSES, NHID, Q, DRAWS = (2048, 1_000_000, 602, 41,
                                                   256, 200_000, 11)
CPU_SUBSAMPLE = 65_536     # edges scored by the CPU f32 reference


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def build_partition(seed=0):
    """The bench partition's generator (bench.py build_partition): a
    power-law degree profile like a Reddit METIS part, as numpy arrays."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.5, N_NODES) + 1.0
    p = w / w.sum()
    senders = rng.choice(N_NODES, N_EDGES, p=p).astype(np.int32)
    receivers = rng.choice(N_NODES, N_EDGES, p=p).astype(np.int32)
    x = rng.normal(size=(N_NODES, FEAT)).astype(np.float32)
    y = rng.integers(0, CLASSES, N_NODES).astype(np.int32)
    train = rng.random(N_NODES) < 0.66
    return x, np.stack([senders, receivers]), y, train


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sum_tolerance(abs_sum):
    # f32 sums taken in another order (atomics): the error stays far below
    # 1e-5 of the summed magnitudes; the floor covers empty rows
    return 1e-5 * abs_sum + 1e-6


def profile_breakdown(torch, fn, top=10):
    """One call of ``fn`` under torch.profiler: device time by kernel name
    (top ``top``), device busy time (union of kernel intervals) and the
    idle share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    check(bool(kernels), "profiler saw no device activity")
    by_name = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) \
            + e.time_range.elapsed_us() / 1e3
    busy, cur_s, cur_e = 0.0, None, None
    for st, en in spans:
        if cur_e is None or st > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    return dict(window_ms=window / 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / window, kernels=len(kernels),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    from sgs_gnn_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card_line,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, library=lib.name)


def phase_kernels(torch, g):
    """Each kernel against its plain version at the serving path's shapes;
    returns {kernel: {main-case numbers, cases}}."""
    from sgs_gnn_tpu_torch.ops import scatter as sc
    from sgs_gnn_tpu_torch.ops import score_sampled as ss
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    receivers, senders = g.receivers, g.senders
    sub = torch.randperm(N_EDGES, generator=gen, device=dev)[:Q]
    results = {}

    # K1 scatter_add: scorer (E=1M receiver-sorted, F=256), backbone per
    # draw (q=200k sampled receivers, F=256 and F=41)
    cases = []
    for case, ids, f in (("scorer E=1M F=256", receivers, NHID),
                         ("backbone q=200k F=256", receivers[sub], NHID),
                         ("backbone q=200k F=41", receivers[sub], CLASSES)):
        e = ids.shape[0]
        vals = torch.randn(e, f, generator=gen, device=dev).to(torch.bfloat16)
        out = sc.scatter_add(vals, ids, N_NODES)
        ref = sc.scatter_add_plain(vals, ids, N_NODES)
        tol = sum_tolerance(sc.scatter_add_plain(vals.abs(), ids, N_NODES))
        err = (out - ref).abs()
        check(bool((err <= tol).all()), f"scatter_add {case}: error "
              f"{float(err.max())} above tolerance")
        vals_f32, ids64 = vals.float(), ids.long()
        nbytes = e * f * 2 + 4 * e + 4 * N_NODES * f
        cases.append(dict(
            case=case, max_abs_err=float(err.max()),
            tolerance="1e-5 * sum|vals| per row + 1e-6 (f32 sums reordered "
                      "by atomics)",
            ms=cuda_ms(torch, lambda: sc.scatter_add(vals, ids, N_NODES)),
            plain_ms=cuda_ms(torch, lambda: sc.scatter_add_plain(
                vals, ids, N_NODES)),
            library_ms=cuda_ms(torch, lambda: torch.zeros(
                N_NODES, f, device=dev).index_add_(0, ids64, vals_f32)),
            bound_ms=max(nbytes / HBM_BPS, e * f / F32_FLOPS) * 1e3,
            bound_by="bytes"))
        emit("kernel", name="scatter_add", **cases[-1])
    results["scatter_add"] = dict(cases[0], cases=cases)

    # K2 segment_sum_scalar: weighted degrees over E=1M sorted receivers
    # (scorer) and q=200k sampled receivers (backbone)
    cases = []
    for case, ids in (("scorer E=1M", receivers),
                      ("backbone q=200k", receivers[sub])):
        e = ids.shape[0]
        w = torch.rand(e, generator=gen, device=dev)
        out = sc.segment_sum_scalar(w, ids, N_NODES)
        ref = sc.segment_sum_scalar_plain(w, ids, N_NODES)
        err = (out - ref).abs()
        check(bool((err <= sum_tolerance(ref)).all()),
              f"segment_sum_scalar {case}: error {float(err.max())}")
        ids64 = ids.long()
        cases.append(dict(
            case=case, max_abs_err=float(err.max()),
            tolerance="1e-5 * sum|w| per node + 1e-6 (f32 sums reordered "
                      "by atomics)",
            ms=cuda_ms(torch, lambda: sc.segment_sum_scalar(w, ids, N_NODES)),
            plain_ms=cuda_ms(torch, lambda: sc.segment_sum_scalar_plain(
                w, ids, N_NODES)),
            library_ms=cuda_ms(torch, lambda: torch.bincount(
                ids64, weights=w, minlength=N_NODES)),
            bound_ms=max((8 * e + 4 * N_NODES) / HBM_BPS,
                         e / F32_FLOPS) * 1e3,
            bound_by="bytes"))
        emit("kernel", name="segment_sum_scalar", **cases[-1])
    results["segment_sum_scalar"] = dict(cases[0], cases=cases)

    # K3 score_head_sampled: all E=1M edges of the partition, F=K=256 bf16
    h = torch.randn(N_NODES, NHID, generator=gen, device=dev).relu().to(
        torch.bfloat16)
    fc1 = torch.randn(2 * NHID, NHID, generator=gen, device=dev) \
        / (2 * NHID) ** 0.5
    b1 = torch.randn(NHID, generator=gen, device=dev) * 0.1
    fc2 = torch.randn(NHID, 1, generator=gen, device=dev) / NHID ** 0.5
    b2 = torch.randn(1, generator=gen, device=dev) * 0.1
    split = ss.split_head(h, fc1, b1, fc2, b2)
    out = ss.score_head_sampled(h, fc1, b1, fc2, b2, senders, receivers)
    ref = ss.score_head_plain(h, *split, senders, receivers)
    err = float((out - ref).abs().max())
    check(err <= 1e-4, f"score_head_sampled: error {err} above 1e-4")
    q = N_EDGES
    flops = 2 * (2 * NHID * NHID) * q
    nbytes = N_NODES * NHID * 2 + 2 * NHID * NHID * 2 + 8 * NHID + 4 \
        + 8 * q + 4 * q
    k3 = dict(case="E=1M F=K=256 bf16", max_abs_err=err,
              tolerance="1e-4 abs on probabilities (same bf16-rounded "
                        "features, f32 sums in another order)",
              ms=cuda_ms(torch, lambda: ss.score_head_sampled(
                  h, fc1, b1, fc2, b2, senders, receivers), iters=10),
              plain_ms=cuda_ms(torch, lambda: ss.score_head_plain(
                  h, *split, senders, receivers), iters=10),
              library_ms=None,
              bound_ms=max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3,
              bound_by="operations")
    emit("kernel", name="score_head_sampled", **k3)
    results["score_head_sampled"] = dict(k3, cases=[k3])
    return results


def phase_serve(torch, arrays):
    from sgs_gnn_tpu_torch import (Config, Graph, get_model, make_predictor,
                                   make_sparsifier)
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.ops._build import LAUNCHES
    x, edge_index, y, train = arrays
    prob = degree_prior(edge_index[0], edge_index[1], N_NODES)
    build_kw = dict(prob=prob, num_classes=CLASSES, sort_by_receiver=True)
    cfg = Config(nhid=NHID, dtype="bfloat16", num_samples_eval=DRAWS)
    g = Graph.build(x, edge_index, y, train, ~train, None, device="cuda",
                    **build_kw)
    model = get_model("GCN", FEAT, NHID, CLASSES, cfg.drop_rate, "GCN",
                      dtype=cfg.dtype, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    sparsify = make_sparsifier(cfg, model, Q)
    predict = make_predictor(cfg, model, Q)
    gen = torch.Generator(device="cuda").manual_seed(1)

    # the main path, once, with every launch counter at 0 just before it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    sp = sparsify(g, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, labels = predict(g, gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    expect = {"scatter_add": 2 + 2 + 2 * DRAWS,
              "segment_sum_scalar": 2 + 2 + 2 * DRAWS,
              "score_head_sampled": 2}
    check(launches == expect, f"launch counts {launches}, expected {expect}")
    check(sp.probs.shape == (N_EDGES,) and sp.probs.dtype == torch.float32,
          f"probs {tuple(sp.probs.shape)} {sp.probs.dtype}")
    check(bool(torch.isfinite(sp.probs).all())
          and bool(((sp.probs >= 0) & (sp.probs <= 1)).all()),
          "probs not finite probabilities")
    check(sp.edge_ids.shape == (Q,)
          and int(torch.unique(sp.edge_ids).numel()) == Q,
          "edge_ids not q distinct edges")
    check(torch.equal(sp.weights, sp.probs[sp.edge_ids]),
          "weights != probs[edge_ids]")
    check(torch.equal(sp.receivers, g.receivers[sp.edge_ids]),
          "receivers != graph receivers[edge_ids]")
    check(logits.shape == (N_NODES, CLASSES)
          and bool(torch.isfinite(logits).all()), "logits not finite")
    check(int(labels.min()) >= 0 and int(labels.max()) < CLASSES,
          "labels out of range")

    # steady-state times (kernels built, caches warm)
    reps = 3
    t = time.perf_counter()
    for _ in range(reps):
        sparsify(g, gen)
    torch.cuda.synchronize()
    sparsify_ms = (time.perf_counter() - t) / reps * 1e3
    t = time.perf_counter()
    predict(g, gen)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t) * 1e3

    for call, fn in (("sparsify", lambda: sparsify(g, gen)),
                     ("predict", lambda: predict(g, gen))):
        emit("profile", call=call, **profile_breakdown(torch, fn))

    # the same port on the CPU in f32 (plain versions), same weights
    t = time.perf_counter()
    g_cpu = Graph.build(x, edge_index, y, train, ~train, None, device="cpu",
                        **build_kw)
    model_cpu = get_model("GCN", FEAT, NHID, CLASSES, cfg.drop_rate, "GCN",
                          dtype="float32", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    sub = np.random.default_rng(2).choice(N_EDGES, CPU_SUBSAMPLE,
                                          replace=False)
    sub_t = torch.from_numpy(sub)
    with torch.no_grad():
        h_cpu = model_cpu.edge_prob_mlp.encode(g_cpu.x, g_cpu.senders,
                                               g_cpu.receivers)
        p_cpu = model_cpu.edge_prob_mlp.score_from(
            h_cpu, g_cpu.senders[sub_t], g_cpu.receivers[sub_t])
        idx = sp.edge_ids.cpu()
        logits_cpu = model_cpu(g_cpu.x, g_cpu.senders[idx],
                               g_cpu.receivers[idx], sp.weights.cpu())
        logits_draw = model(g.x, sp.senders, sp.receivers, sp.weights).cpu()
    cpu_s = time.perf_counter() - t
    p_err = (sp.probs.cpu()[sub_t] - p_cpu).abs()
    l_err = (logits_draw - logits_cpu).abs()
    l_scale = float(logits_cpu.abs().max())
    emit("serve", nodes=N_NODES, edges=N_EDGES, features=FEAT, nhid=NHID,
         classes=CLASSES, q=Q, draws=DRAWS, dtype=cfg.dtype,
         receiver_band=g.receiver_band,
         first_sparsify_ms=(t1 - t0) * 1e3, first_predict_ms=(t2 - t1) * 1e3,
         sparsify_ms=sparsify_ms, edges_per_s=N_EDGES / sparsify_ms * 1e3,
         predict_ms=predict_ms, max_memory_allocated=peak, launches=launches,
         cpu_reference_s=cpu_s, cpu_subsample=CPU_SUBSAMPLE,
         probs_max_abs_err=float(p_err.max()),
         probs_mean_abs_err=float(p_err.mean()),
         logits_max_abs_err=float(l_err.max()), logits_max_abs=l_scale)
    # bf16 card run against the f32 CPU run: bf16 rounds inputs, weights and
    # every projection to 8 significant bits (relative 2^-9 per rounding),
    # compounded over 2 GCN layers and the head
    # (the same comparison on the CPU at E=100k gave a probs error of 6e-4
    # max, 6e-5 mean, and a logits error of 0.4% of the largest logit)
    check(float(p_err.max()) <= 1e-2 and float(p_err.mean()) <= 1e-3,
          f"probs: card bf16 vs CPU f32 max {float(p_err.max())}, mean "
          f"{float(p_err.mean())} (limits 1e-2, 1e-3)")
    check(float(l_err.max()) <= 0.02 * max(l_scale, 1.0),
          f"backbone logits on the sparsified draw: card bf16 vs CPU f32 "
          f"max {float(l_err.max())} (limit 2% of max |logit| {l_scale})")
    return launches


KERNELS = {
    "scatter_add": ("sgs_gnn_tpu_torch/csrc/scatter.cu",
                    "sgs_gnn_tpu/ops/scatter_pallas.py:197"),
    "segment_sum_scalar": ("sgs_gnn_tpu_torch/csrc/segment_sum.cu",
                           "sgs_gnn_tpu/ops/scatter_pallas.py:265"),
    "score_head_sampled": ("sgs_gnn_tpu_torch/csrc/score_sampled.cu",
                           "sgs_gnn_tpu/ops/score_sampled.py:127"),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port itself: without it (this script alone) fail before printing
    from sgs_gnn_tpu_torch import Graph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)

    arrays = build_partition()
    x, edge_index, y, train = arrays
    g = Graph.build(x, edge_index, y, train, ~train, None, device="cuda",
                    sort_by_receiver=True)
    kernels = phase_kernels(torch, g)
    del g
    launches = phase_serve(torch, arrays)

    line = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name, 0), max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            matched=True, case=k["case"], cases=k["cases"]))
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

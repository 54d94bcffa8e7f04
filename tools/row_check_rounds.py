#!/usr/bin/env python3
"""Margins of the row kernels' checks (K1, K2, K7, K8) over fresh values,
on one NVIDIA card.

    python3 tools/row_check_rounds.py [ROUNDS]

Runs every row-kernel case of chip_smoke.py's ``kernel`` phase on the bench
partition's ids: K1 and K2 on ``row_cases``, K7 on ``sorted_cases``, K8 on
``spmm_cases`` and the coalesced edge list, each for ROUNDS rounds (default
20) with fresh values. A case's ``err_over_limit`` is its largest
|kernel - reference| / (1e-5 * sum|terms| + 1e-6) over the output's
elements (a pass is <= 1), taken twice: against the plain version's f64
sum (``acc_dtype=torch.float64``, what chip_smoke.py checks) and against
the f32 plain version (``index_add_`` in f32, atomics in the card's order;
its magnitudes summed in f32 too). Prints the card's name and power limit
first, then one JSON line per case: the largest of each over the rounds,
the largest absolute errors and the rounds each reference would fail; last
a summary line. Imports the port and chip_smoke.py, nothing of JAX. Needs
a card.
"""
import importlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def over_limit(cs, got, ref, abs_sum):
    """(largest |got - ref|, largest |got - ref| / limit), in f64."""
    err = (got.double() - ref.double()).abs()
    return (float(err.max()),
            float((err / cs.sum_tolerance(abs_sum.double())).max()))


def main():
    import torch
    if not torch.cuda.is_available():
        print("row_check_rounds: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sgs_gnn_tpu_torch import Graph
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.ops import scatter as sc
    sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    n, f64, dev = cs.N_NODES, torch.float64, cs.DEVICE
    x, edge_index, y, train = cs.build_partition()
    g = Graph.build(x, edge_index, y, train, ~train, None, device=dev,
                    prob=degree_prior(edge_index[0], edge_index[1], n),
                    sort_by_receiver=True, tile_index=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_cases, k2_cases = cs.row_cases(torch, g, gen)
    worst = {}

    def record(kernel, case, got, plain, terms_abs):
        """``plain(acc_dtype)`` sums the case's terms, ``terms_abs`` their
        magnitudes, in that dtype."""
        ref64 = plain(f64)
        ref32 = plain(torch.float32)
        e64, r64 = over_limit(cs, got, ref64, terms_abs(f64))
        e32, r32 = over_limit(cs, got, ref32, terms_abs(torch.float32))
        w = worst.setdefault((kernel, case), dict(
            err_over_limit_f64=0.0, err_over_limit_f32=0.0,
            max_abs_err_f64=0.0, max_abs_err_f32=0.0, fails_f64=0,
            fails_f32=0))
        w["err_over_limit_f64"] = max(w["err_over_limit_f64"], r64)
        w["err_over_limit_f32"] = max(w["err_over_limit_f32"], r32)
        w["max_abs_err_f64"] = max(w["max_abs_err_f64"], e64)
        w["max_abs_err_f32"] = max(w["max_abs_err_f32"], e32)
        w["fails_f64"] += int(r64 > 1)
        w["fails_f32"] += int(r32 > 1)

    for _ in range(rounds):
        for case, ids, f, dtype in k1_cases:
            vals = torch.randn(ids.shape[0], f, generator=gen,
                               device=dev).to(dtype)
            record("scatter_add", case, sc.scatter_add(vals, ids, n),
                   lambda a: sc.scatter_add_plain(vals, ids, n, acc_dtype=a),
                   lambda a: sc.scatter_add_plain(vals.abs(), ids, n,
                                                  acc_dtype=a))
        for case, ids in k2_cases:
            w = torch.rand(ids.shape[0], generator=gen, device=dev)
            plain = (lambda a: sc.segment_sum_scalar_plain(w, ids, n,
                                                           acc_dtype=a))
            record("segment_sum_scalar", case,
                   sc.segment_sum_scalar(w, ids, n), plain, plain)
        for case, v, i, b, _ in cs.sorted_cases(torch, g, gen):
            record("scatter_add_sorted", case,
                   sc.scatter_add_sorted(v, i, n, b),
                   lambda a: sc.scatter_add_sorted_plain(v, i, n, b,
                                                         acc_dtype=a),
                   lambda a: sc.scatter_add_sorted_plain(v.abs(), i, n, b,
                                                         acc_dtype=a))
        for case, s, r, w, xv, *_ in cs.spmm_cases(torch, g, gen):
            runs = [(case, s, r, w)]
            if case == "E=1M F=256 bf16 unweighted receiver-sorted":
                runs.append(("coalesced", *cs.coalesced(torch, s, r, w)))
            for name, s_, r_, w_ in runs:
                record("spmm_fused", name, sp._spmm_fused(s_, r_, w_, xv, n),
                       lambda a: sp.spmm_fused_plain(s_, r_, w_, xv, n,
                                                     acc_dtype=a),
                       lambda a: sp.spmm_fused_plain(s_, r_, w_, xv.abs(),
                                                     n, acc_dtype=a))
        torch.cuda.synchronize()
    for (kernel, case), w in worst.items():
        print(json.dumps(dict(kernel=kernel, case=case, rounds=rounds, **w)),
              flush=True)
    top = max(worst.items(), key=lambda kv: kv[1]["err_over_limit_f64"])
    print(json.dumps(dict(
        rounds=rounds, cases=len(worst),
        largest_err_over_limit_f64=top[1]["err_over_limit_f64"],
        at=list(top[0]),
        cases_over_half_f64=[list(k) for k, w in worst.items()
                             if w["err_over_limit_f64"] > 0.5],
        rounds_failed_f64=sum(w["fails_f64"] for w in worst.values()),
        rounds_failed_f32=sum(w["fails_f32"] for w in worst.values()))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

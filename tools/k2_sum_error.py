#!/usr/bin/env python3
"""Rounding error of K2 (``segment_sum_scalar``) and of its plain version
on the ids chip_smoke.py's ``kernel`` phase gives them, against an f64 sum.

    python3 tools/k2_sum_error.py [REPEATS]

For each K2 case of ``chip_smoke.row_cases`` (the bench partition), each of
REPEATS rounds draws fresh U(0, 1) weights and sums them three ways: K2 on
the card, the plain version (``index_add_`` in f32, atomics in the card's
order) and ``index_add_`` in f64. Prints one JSON line per case: the
largest |K2 - plain|, |K2 - f64| and |plain - f64| over the rounds, each
also relative to its node's sum of weights, and how many rounds the smoke's
check (|K2 - plain| <= 1e-5 * sum + 1e-6 per node) would have failed; and
first the card's name and power limit. Needs a card.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import torch
    if not torch.cuda.is_available():
        print("k2_sum_error: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sgs_gnn_tpu_torch import Graph
    from sgs_gnn_tpu_torch.data import degree_prior
    from sgs_gnn_tpu_torch.ops import scatter as sc
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    x, edge_index, y, train = cs.build_partition()
    g = Graph.build(x, edge_index, y, train, ~train, None, device="cuda",
                    prob=degree_prior(edge_index[0], edge_index[1],
                                      cs.N_NODES),
                    sort_by_receiver=True, tile_index=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, k2_cases = cs.row_cases(torch, g, gen)
    for case, ids in k2_cases:
        worst = dict(kernel_vs_plain=0.0, kernel_vs_f64=0.0,
                     plain_vs_f64=0.0, kernel_vs_plain_rel=0.0,
                     kernel_vs_f64_rel=0.0, plain_vs_f64_rel=0.0)
        fails = 0
        for _ in range(repeats):
            w = torch.rand(ids.shape[0], generator=gen, device="cuda")
            k = sc.segment_sum_scalar(w, ids, cs.N_NODES).double()
            p = sc.segment_sum_scalar_plain(w, ids, cs.N_NODES).double()
            exact = torch.zeros(cs.N_NODES, dtype=torch.float64,
                                device="cuda").index_add_(0, ids.long(),
                                                          w.double())
            scale = exact.clamp(min=1e-30)
            for name, a, b in (("kernel_vs_plain", k, p),
                               ("kernel_vs_f64", k, exact),
                               ("plain_vs_f64", p, exact)):
                d = (a - b).abs()
                worst[name] = max(worst[name], float(d.max()))
                worst[name + "_rel"] = max(worst[name + "_rel"],
                                           float((d / scale).max()))
            fails += int(not bool(((k - p).abs()
                                   <= cs.sum_tolerance(p)).all()))
        print(json.dumps(dict(case=case, edges=int(ids.shape[0]),
                              repeats=repeats,
                              max_node_sum=float(exact.max()),
                              max_node_items=int(np.bincount(
                                  ids.cpu().numpy()).max()),
                              smoke_check_failures=fails, **worst)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings behind the graphed route's limits, on one NVIDIA card.

    python3 tools/graphed_readings.py noise        # the card tests' limits
    python3 tools/graphed_readings.py k2_ghost     # the padded K2 check
    python3 tools/graphed_readings.py first_epoch  # capture epoch A/B
    python3 tools/graphed_readings.py experiment_noise  # route limits

``noise``: the setup of tests/test_torch_cuda.py's graphed-epoch test (4
partitions, a plan with skip, small and sampled batches, 3 epochs) per
mode, run eager twice and graphed once from the same seeds: the largest
relative L2 distance between a parameter tensor of two runs and the
largest relative difference of an epoch's summed loss, graphed vs eager
and eager vs eager.

``k2_ghost``: 40 calls of the padded-partition K2 check of the same file:
the ghost node's sum (~0.9M weights) from K2, from the plain version
(f32 ``index_add_``) and in f64, and how often each f32 sum misses the
test's limit against the other or against f64.

``first_epoch``: chip_smoke.py's experiment cell (learned and edge, 2
epochs) through ``run_experiment`` with graphs, where epoch 0 runs each
(shape class, case) eagerly and captures it; ``Graphs.run`` as it is
(each graph draws from a generator of its own that takes the caller's
state) against registering the caller's generator with the graph, in
turns (own, caller, caller, own) three times in one process.

``experiment_noise``: chip_smoke.py's experiment cell, learned, 2 epochs,
for the GCN backbone with the GCN scorer and the GAT backbone with the
GraphSAGE scorer (the latter with ``--dense_subgraph`` off and on: on,
the scorer's encoder and the random forward aggregate with (N, N)
products instead of K1's and K2's atomics), each run eager, graphed,
graphed, eager from the same seeds: the losses, F1 curves and conditional
(edge-group) updates of every run, and the largest relative loss
difference and F1 difference of each pair of runs (graphed vs eager,
eager vs eager, graphed vs graphed).
"""
import functools
import importlib.util
import json
import sys
import tempfile
import time

import torch

sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
CARD = torch.device("cuda")


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "card_tests", "tests/test_torch_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    return [float((x - y).norm() / y.norm().clamp(min=1e-30))
            for x, y in zip(a, b)]


def noise():
    from sgs_gnn_tpu_torch import Config, make_train_step
    from sgs_gnn_tpu_torch.train import make_scan_epoch_step
    t = _card_tests()
    for name in t.GRAPHED_KW:
        cfg = Config(**t.GRAPHED_BASE, **t.GRAPHED_KW[name])
        batches, plan, q, classes = t._graphed_batches(CARD, cfg)
        runs = {}
        for route in ("eager", "eager2", "graphed"):
            tm, opt = t._graphed_model(CARD, cfg, batches, classes)
            if route == "graphed":
                steps = make_scan_epoch_step(cfg, tm, opt, q, 4,
                                             len(batches))
            else:
                steps = {2: make_train_step(cfg, tm, opt, q, 4),
                         1: make_train_step(cfg, tm, opt, q, 4,
                                            force_small=True)}
            sums = t._run_epochs(steps, batches, plan, 3,
                                 torch.Generator(device=CARD))
            torch.cuda.synchronize()
            runs[route] = (sums, [p.detach().clone()
                                  for p in tm.parameters()])
        (s_e, p_e), (s_e2, p_e2), (s_g, p_g) = (
            runs["eager"], runs["eager2"], runs["graphed"])

        def loss_rel(a, b):
            return max(abs(x[0] - y[0]) / abs(y[0]) for x, y in zip(a, b))
        print(json.dumps(dict(
            reading="noise", mode=name,
            param_rel_l2_graphed_eager=max(_rel(p_g, p_e)),
            param_rel_l2_eager_eager=max(_rel(p_e2, p_e)),
            loss_rel_graphed_eager=loss_rel(s_g, s_e),
            loss_rel_eager_eager=loss_rel(s_e2, s_e))), flush=True)


def k2_ghost():
    from sgs_gnn_tpu_torch.ops import scatter as sc
    t = _card_tests()
    batches = t._padded_partitions(CARD)
    g = min(batches, key=lambda b: int(b.edge_mask.sum()))
    ghost = g.num_nodes - 1
    ids = g.receivers.long()
    fails = dict(kernel_vs_plain=0, kernel_vs_f64=0, plain_vs_f64=0)
    err = dict(kernel=0.0, plain=0.0)
    calls = 40
    for _ in range(calls):
        # the test's draws: its K1 values first, then the weights
        gen = torch.Generator(device=CARD).manual_seed(3)
        for _ in range(2):
            for f in (256, 41):
                torch.randn(g.num_edges, f, generator=gen, device=CARD)
        w = torch.rand(g.num_edges, generator=gen, device=CARD)
        out = sc.segment_sum_scalar(w, g.receivers, g.num_nodes).double()
        plain = sc.segment_sum_scalar_plain(w, g.receivers,
                                            g.num_nodes).double()
        exact = torch.zeros(g.num_nodes, dtype=torch.float64,
                            device=CARD).index_add_(0, ids, w.double())
        for key, (a, b) in dict(kernel_vs_plain=(out, plain),
                                kernel_vs_f64=(out, exact),
                                plain_vs_f64=(plain, exact)).items():
            fails[key] += not bool(((a - b).abs()
                                    <= t._sum_tol(b)).all())
        err["kernel"] = max(err["kernel"],
                            abs(float(out[ghost] - exact[ghost])))
        err["plain"] = max(err["plain"],
                           abs(float(plain[ghost] - exact[ghost])))
    print(json.dumps(dict(
        reading="k2_ghost", calls=calls, ghost_items=int((ids == ghost).sum()),
        ghost_sum=float(exact[ghost]),
        ghost_limit=float(t._sum_tol(exact[ghost])),
        max_abs_err_vs_f64=err, calls_over_limit=fails)), flush=True)


def _run_with_caller_generator(self, key, body, pool, generator=None):
    """``Graphs.run`` registering the caller's generator with the graph."""
    cap = self.by_key.get(key)
    if cap is not None:
        return cap.replay()
    out = body(generator)
    self.by_key[key] = self._capture(
        functools.partial(body, generator), pool=pool,
        generators=() if generator is None else (generator,))
    return out


def first_epoch():
    import chip_smoke as cs
    from sgs_gnn_tpu_torch.core import graphed
    from sgs_gnn_tpu_torch.run import driver
    from sgs_gnn_tpu_torch.run.cli import config_from_args
    own = graphed.Graphs.run
    cs.phase_serve(torch, cs.build_partition())     # kernels built, warm
    ds = cs.experiment_dataset()
    with tempfile.TemporaryDirectory() as results_dir:
        for rep in range(3):
            for name, run in (("own", own),
                              ("caller", _run_with_caller_generator),
                              ("caller", _run_with_caller_generator),
                              ("own", own)):
                graphed.Graphs.run = run
                for mode in ("learned", "edge"):
                    cfg = config_from_args(cs.experiment_args(
                        mode, results_dir, extra=["--save_csv", "false"]))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (res,) = driver.run_experiment(
                        cfg, ds, log_fn=lambda line: None, device="cuda")
                    torch.cuda.synchronize()
                    print(json.dumps(dict(
                        reading="first_epoch", rep=rep, generator=name,
                        mode=mode, epoch_s=res.epoch_times,
                        eval_ms=[t * 1e3 for t in res.eval_times],
                        run_s=time.perf_counter() - t0,
                        losses=res.losses, graphs=res.graphs)), flush=True)
                    torch.cuda.empty_cache()
    graphed.Graphs.run = own


def experiment_noise():
    import itertools
    import chip_smoke as cs
    from sgs_gnn_tpu_torch.run import driver
    from sgs_gnn_tpu_torch.run.cli import config_from_args
    cs.phase_serve(torch, cs.build_partition())     # kernels built, warm
    ds = cs.experiment_dataset()
    with tempfile.TemporaryDirectory() as results_dir:
        for gnn, scorer, dense in (("GCN", "GCN", "off"),
                                   ("GAT", "GSAGE", "off"),
                                   ("GAT", "GSAGE", "on")):
            model = f"{gnn}+{scorer} dense_subgraph={dense}"
            runs = []
            for route in ("eager", "graphed", "graphed", "eager"):
                extra = ["--GNN", gnn, "--edge_mlp_type", scorer,
                         "--dense_subgraph", dense, "--save_csv", "false"]
                if route == "eager":
                    extra += ["--scan_epoch", "off"]
                cfg = config_from_args(cs.experiment_args(
                    "learned", results_dir, extra=extra))
                (res,) = driver.run_experiment(
                    cfg, ds, log_fn=lambda line: None, device="cuda")
                curves = res.train_curve + res.val_curve + res.test_curve
                runs.append((route, res.losses, curves))
                print(json.dumps(dict(
                    reading="experiment_noise", model=model,
                    route=route, losses=res.losses, f1_curves=curves,
                    edge_updates=res.conditional_updates)), flush=True)
                torch.cuda.empty_cache()
            for (ra, la, ca), (rb, lb, cb) in itertools.combinations(runs, 2):
                print(json.dumps(dict(
                    reading="experiment_noise_pair", model=model,
                    pair=f"{ra} vs {rb}",
                    loss_rel=max(abs(a - b) / abs(b) for a, b in zip(la, lb)),
                    f1_abs=max(abs(a - b) for a, b in zip(ca, cb)))),
                    flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("graphed_readings: needs an NVIDIA card")
    for what in sys.argv[1:] or ["noise", "k2_ghost", "first_epoch",
                                 "experiment_noise"]:
        dict(noise=noise, k2_ghost=k2_ghost, first_epoch=first_epoch,
             experiment_noise=experiment_noise)[what]()

"""The comparison that decides ``correct``: what the program produced in
its run, against the plain reference (``benchmark/reference.py``) worked
out again from the benchmark's own inputs.

Numbers compared (each against its limit in ``limits/<cell>.json``):

  batch_mismatch  fields of the checked batches that differ from the
                  reference's rebuild, and faults of the partition the
                  rebuild starts from: a node outside every part, an
                  empty part, more parts than the edges call for, a
                  batch whose valid edges or train, val or test nodes
                  are not its part's, or as many real nodes as padded
                  ones (no ghost); in the train cells also the last
                  eval's mask sizes that differ (exact: limit 0);
  loss_gap        worst of the checked steps' |loss - ref| / |ref|;
  grad1_gap       the first step's gradient as the program's optimizer
                  took it, worst leaf of |‖g‖ - ‖g_ref‖| / max(‖g_ref‖,
                  median leaf's ‖g_ref‖);
  grad1_out       the first gradient of the leaves that make the logits'
                  bias (the backbone's 1-D leaves of one entry a class):
                  worst of ‖g - g_ref‖ / ‖g_ref‖. That gradient is the
                  mean over the train nodes of each node's loss gradient
                  at the logits, so a mean over part of the nodes moves
                  its direction, where the norms above move by the
                  halving's sampling noise alone;
  change3_gap     the parameters' change over the checked steps, worst
                  leaf, measured alike;
  eval_gap        train cells: the last eval the program ran (in the
                  window, on the parameters it ran with), worst of the
                  train, val and test masks of |correct - ref| / size,
                  the correct predictions summed over every partition;
  winner_miss     learned training: the share of the program's q winners
                  that are not among the reference's own top-q under the
                  same draws, worst step;
  gate_gap        learned training: where the program's conditional gate
                  differs from the reference's own, the reference's
                  |learned F1 - random F1| (0 where they agree);
  logit_gap       serving: worst request of max |logit - ref| over the
                  partition's real nodes, over the rms of the reference's
                  logits there.

The eval is the one number worked out from the program's own state (its
parameters after the window's training); the checked steps check how the
program reached such a state.

Leaves whose reference gradient stays under a thousandth of the median
leaf's in every checked step move by rounding alone and are left out of
grad1_gap and change3_gap.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import reference as R
from . import schedule

BATCH_FIELDS = ("x", "senders", "receivers", "y", "train_mask", "val_mask",
                "test_mask", "prob", "edge_mask", "edge_aux", "tile_ls",
                "tile_lr", "tile_su", "tile_rv", "tile_perm", "tile_prob",
                "tile_mask", "tile_aux")
TINY_LEAF = 1e-3
SPLITS = ("train", "val", "test")


def batch_arrays(g):
    """The program's batch as host numpy arrays, with its tile sizes."""
    out = {}
    for k in BATCH_FIELDS:
        v = getattr(g, k, None)
        if v is not None:
            out[k] = v.detach().cpu().numpy()
    out["tile_t"], out["tile_b"] = g.tile_t, g.tile_b
    return out


def rebuild(run, bi):
    """The reference's batch bi and the count of the program's fields
    that differ from it."""
    n, e, slots = run.shapes_of[bi]
    prog = run.prog_batches[bi]
    ref = R.build_batch(run.inputs, run.part, bi, n, e, tiles=slots > 0,
                        tile_slots=slots)
    bad = [k for k in BATCH_FIELDS if (k in prog) != (k in ref)
           or (k in prog and not np.array_equal(prog[k], ref[k]))]
    if slots and (prog["tile_t"], prog["tile_b"]) != (ref["tile_t"],
                                                      ref["tile_b"]):
        bad.append("tile_t")
    return ref, bad


def partition_faults(run):
    """What the rebuild cannot see, since it starts from the program's
    partition: the partition checked against the inputs and against
    every batch the program built from it."""
    part, k = np.asarray(run.part), run.num_parts
    ei, masks = run.inputs[1], run.inputs[3]
    bad = []
    if part.shape != (run.inputs[0].shape[0],):
        return ["part.shape"]
    inside = (part >= 0) & (part < k)
    if not inside.all():
        bad.append("part.node_outside")
    sizes = np.bincount(part[inside], minlength=k)[:k]
    if (sizes == 0).any():
        bad.append("part.empty")
    cap = -(-ei.shape[1] // run.cell.flags()["metis_threshold"])
    if k > cap or len(run.shapes_of) != k:
        bad.append("part.count")
    ps, pr = part[ei[0]], part[ei[1]]
    same = (ps == pr) & (ps >= 0) & (ps < k)
    edges = np.bincount(ps[same], minlength=k)[:k]
    for bi in range(min(k, len(run.shapes_of))):
        if edges[bi] != run.valid_e[bi]:
            bad.append(f"part.{bi}.edges")
        if sizes[bi] >= run.shapes_of[bi][0]:
            bad.append(f"part.{bi}.nodes")
        for j, m in enumerate(masks):
            if int(m[part == bi].sum()) != run.split_counts[bi][j]:
                bad.append(f"part.{bi}.{SPLITS[j]}")
    return bad


def check(run, precision=None, control=False):
    pr = precision or R.F32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if run.cell.traffic["loop"] == "train_epochs":
        return _check_train(run, pr, control)
    return _check_serve(run, pr, control)


def _ref_params(weights):
    return {k: v.detach().clone().float().requires_grad_(True)
            for k, v in weights.items()}


def _follow(run, gbs, pr, winners, gates):
    """The reference's checked steps from the benchmark's weights:
    (losses, first gradients, every step's gradient norms, final
    parameters, per-step facts)."""
    cfg = run.cell.ref_cfg()
    P = _ref_params(run.weights)
    names = list(P)
    params = [P[k] for k in names]
    model = R.Model(cfg, P, pr)
    adam = R.DualAdam(names, cfg["GNN"], cfg["lr"], cfg["weight_decay"])
    losses, facts, grad_norms, grad1 = [], [], [], None
    mode = run.cell.mode
    for k, (bi, g) in enumerate(gbs):
        gen = torch.Generator(device=run.device)
        gen.manual_seed(run.seed_of(bi + 1))
        small = run.plan[bi] == 1
        if small:
            total, f = R.small_step(model, cfg, g, gen)
        elif mode == "learned":
            total, f = R.learned_step(
                model, cfg, g, gen, run.q,
                None if winners is None else winners[k].to(run.device),
                None if gates is None else gates[k])
        else:
            total, f = R.random_step(model, cfg, g, gen, run.q)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr
                 for gr, p in zip(grads, params)]
        if k == 0:
            grad1 = {}
            for nm, gr, p in zip(names, grads, params):
                if mode != "learned":
                    gr = gr + cfg["weight_decay"] * p.detach()
                grad1[nm] = gr.detach()
        grad_norms.append({nm: R.param_norm(gr)
                           for nm, gr in zip(names, grads)})
        adam.step(params, grads, mode, f.get("used_gate", True), small)
        losses.append(float(total.detach()))
        facts.append(f)
    return losses, grad1, grad_norms, {k: P[k].detach() for k in names}, \
        facts


def _kept_leaves(grad_norms):
    """Leaves whose reference gradient reaches a thousandth of the median
    leaf's in some checked step."""
    keep = set()
    for norms in grad_norms:
        med = float(np.median(list(norms.values())))
        keep |= {k for k, v in norms.items() if v >= TINY_LEAF * med}
    return keep


def _check_train(run, pr, control):
    rec = run.rec
    gbs, bad = [], partition_faults(run)
    for bi in rec["batches"]:
        ref, mismatch = rebuild(run, bi)
        bad += [f"{bi}.{k}" for k in mismatch]
        gbs.append((bi, R.to_device(ref, run.device)))
    if control:
        # the reference in the lower precision takes the program's place,
        # its own winners and gates; the f32 reference follows them
        c_loss, c_g1, _, c_par, c_facts = _follow(run, gbs, pr, None, None)
        prog = dict(losses=c_loss, grad1=c_g1, params=c_par,
                    winners=[f.get("winners") for f in c_facts],
                    gates=[f.get("gate", False) for f in c_facts])
        pr = R.F32
    else:
        prog = dict(losses=rec["losses"], grad1=rec["grad1"],
                    params=rec["params"], winners=rec["winners"],
                    gates=[bool(g) for g in rec["gates"]])
    learned = run.cell.mode == "learned"
    losses, grad1, norms, params, facts = _follow(
        run, gbs, pr, prog["winners"] if learned else None,
        prog["gates"] if learned else None)
    keep = _kept_leaves(norms)
    out = {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                           for a, b in zip(prog["losses"], losses))}
    pg1 = {k: v.to(run.device) for k, v in prog["grad1"].items()
           if v is not None}
    g1_keys = [k for k in keep if k in pg1]
    out["grad1_gap"], worst_g = R.leaf_gaps(pg1, grad1, g1_keys)
    out_bias = [k for k in g1_keys if "edge_prob_mlp" not in k
                and tuple(grad1[k].shape) == (run.num_classes,)]
    out["grad1_out"] = (R.leaf_diffs(pg1, grad1, out_bias)[0] if out_bias
                        else float("inf"))
    w0 = run.weights
    d_prog = {k: prog["params"][k].to(run.device).float() - w0[k]
              for k in keep}
    d_ref = {k: params[k] - w0[k] for k in keep}
    out["change3_gap"], worst_c = R.leaf_gaps(d_prog, d_ref, sorted(keep))
    out["eval_gap"], eval_bad = _check_eval(run, pr, control)
    bad += eval_bad
    out["batch_mismatch"] = float(len(bad))
    print(f"check: worst leaves: grad1 {worst_g}, change3 {worst_c}; "
          f"losses {prog['losses']} against {losses}", file=sys.stderr,
          flush=True)
    if learned:
        miss, gate = [0.0], [0.0]
        for pw, f in zip(prog["winners"], facts):
            if pw is None:      # a small step draws no winners
                continue
            own = set(f["winners"].cpu().tolist())
            miss.append(1.0 - len(own & set(pw.cpu().tolist())) / len(own))
            gate.append(0.0 if f["gate"] == f["used_gate"]
                        else abs(f["lf1"] - f["rf1"]))
        out["winner_miss"] = max(miss)
        out["gate_gap"] = max(gate)
    if bad:
        print("check: batch fields that differ: " + " ".join(bad[:20]),
              file=sys.stderr, flush=True)
    return out


def _check_eval(run, pr, control):
    """(eval_gap, mask sizes that differ) of the program's last eval,
    worked out again on every partition rebuilt from the inputs, with the
    draws of the same streams; the control's own eval in the program's
    place."""
    cfg = run.cell.ref_cfg()
    rec = run.eval_rec
    P = {k: v.to(run.device) for k, v in rec["params"].items()}
    ref_model = R.Model(cfg, P, R.F32 if control else pr)
    ctl_model = R.Model(cfg, P, pr) if control else None
    stream = schedule.batch_seed(run.seed, 0,
                                 schedule.EVAL_STREAM + rec["epoch"])
    draws = run.cell.traffic["num_samples_eval"]
    want = {s: [0, 0] for s in SPLITS}
    ctl = {s: [0, 0] for s in SPLITS}
    for bi in range(len(run.shapes_of)):
        n, e, _ = run.shapes_of[bi]
        g = R.to_device(R.build_batch(run.inputs, run.part, bi, n, e,
                                      tiles=False), run.device)
        for model, acc in ((ref_model, want), (ctl_model, ctl)):
            if model is None:
                continue
            gen = torch.Generator(device=run.device)
            gen.manual_seed(stream)
            res = R.evaluate(model, cfg, g, gen, run.q, draws,
                             run.cell.mode, bool(run.small[bi]))
            for s in SPLITS:
                acc[s][0] += res[s][0]
                acc[s][1] += res[s][1]
    if control:
        got = {s: ctl[s] for s in SPLITS}
    else:
        got = {s: [rec["sums"][f"{s}_f1_weighted"], rec["sums"][f"{s}_count"]]
               for s in SPLITS}
    bad = [f"eval.{s}_count" for s in SPLITS if got[s][1] != want[s][1]]
    gap = max(abs(got[s][0] - want[s][0]) / max(want[s][1], 1)
              for s in SPLITS)
    print(f"check: eval of epoch {rec['epoch']}: correct/size "
          + " ".join(f"{s} {got[s][0]:.0f}/{got[s][1]:.0f} against "
                     f"{want[s][0]}/{want[s][1]}" for s in SPLITS),
          file=sys.stderr, flush=True)
    return gap, bad


def _check_serve(run, pr, control):
    cfg = run.cell.ref_cfg()
    draws = run.cell.traffic["num_samples_eval"]
    P = {k: v.detach().float() for k, v in run.weights.items()}
    ref_model = R.Model(cfg, P, R.F32 if control else pr)
    ctl_model = R.Model(cfg, P, pr) if control else None
    bad, gaps, cache = partition_faults(run), [], {}
    for i, p, logits in run.kept:
        if p not in cache:
            ref, mismatch = rebuild(run, p)
            bad += [f"{p}.{k}" for k in mismatch]
            cache[p] = R.to_device(ref, run.device)
        g = cache[p]

        def answer(model):
            gen = torch.Generator(device=run.device)
            gen.manual_seed(schedule.batch_seed(run.seed, schedule.SERVE_RUN,
                                                i))
            return R.predict(model, cfg, g, gen, run.q, draws)
        want = answer(ref_model)
        got = (answer(ctl_model) if control
               else logits.to(run.device).float())
        n = int(run.real_n[p])
        d = (got[:n] - want[:n]).abs().max()
        rms = want[:n].pow(2).mean().sqrt()
        gaps.append(float(d / rms))
    if bad:
        print("check: batch fields that differ: " + " ".join(bad[:20]),
              file=sys.stderr, flush=True)
    return {"batch_mismatch": float(len(bad)),
            "logit_gap": max(gaps) if gaps else float("inf")}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number the cell's limits
    name is there and at or under its limit. Numbers without a limit are
    read, not compared (PERF.md gives their readings)."""
    rows = [(k, numbers.get(k, float("inf")), lim)
            for k, lim in limits.items()]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)
    return ok, rows

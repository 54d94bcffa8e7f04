"""One run of one cell: set-up, the measured window, the traced stretch,
and the comparison with the plain reference that decides ``correct``.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is read from its own file, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (the flags the program runs with and the graph's
sizes), ``traffic/<mix>.json`` (the loop, the mode, the draws),
``limits/<cell>.json`` (the limit of each number compared),
``metrics/<metric>.py`` (a reader of the traced stretch) and
``archs/backbone_<GNN>.py``, ``archs/scorer_<edge_mlp_type>.py`` (each
architecture's plain reference and count).

A reader gets ``ctx``: the trace (``trace.Trace``), the window's facts,
the cell, the set-up's stages, the shapes, and ``program``, the
program's own record of the traced stretch (``core/spans.py``
``collect()``: spans, counters, stamped device segments). The program's
tracing is on, from before the set-up, only in a ``--trace 1`` run of a
cell that reports a metric of source ``program_span`` or
``program_counter``; elsewhere the record holds the launch and route
counters alone.

The program is the port, ``sgs_gnn_tpu_torch``: its data layer
(``run.driver.prepare_batches``), its graphed epoch and eval
(``train.make_scan_epoch_step``, ``eval.make_scan_eval_step``) and its
serving call (``run.serve.make_predictor``), driven as the port's driver
drives them. The benchmark makes the inputs and the weights from the seed
and hands the same to the program and to the reference
(``benchmark/reference.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, datagen, schedule, trace
from .reference import make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sgs_gnn_tpu")
PROGRAM_SOURCES = ("program_span", "program_counter")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def manifest():
    return load_json(ROOT / "BENCHMARK.json")


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    limits. ``graph`` overrides the configuration's graph sizes (the CPU
    tests' small graphs)."""

    def __init__(self, name, graph=None, flags=None, bench=None):
        bench = bench or manifest()
        self.bench = bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        confs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / confs[self.workload["config"]]["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        lim = HERE / "limits" / f"{name}.json"
        self.limits = load_json(lim) if lim.exists() else {}
        self.graph = dict(self.config["graph"], **(graph or {}))
        self.config["flags"].update(flags or {})

    @property
    def mode(self):
        return self.traffic["mode"]

    def flags(self):
        """The port's ``Config`` fields of this cell."""
        return dict(self.config["flags"], mode=self.mode,
                    num_samples_eval=self.traffic["num_samples_eval"])

    def ref_cfg(self):
        """The reference's view of the configuration."""
        f = self.flags()
        return dict(f, num_features=self.graph["num_features"],
                    num_classes=self.graph["num_classes"])

    def per_layer(self):
        """The entries of the per-layer metrics this cell reports."""
        return [m for m in self.bench["per_layer"]
                if "workloads" not in m or self.name in m["workloads"]]

    def reads_program(self):
        """Whether a per-layer metric of this cell reads the program's
        own spans or counters (``core/spans.py``)."""
        return any(m["source"] in PROGRAM_SOURCES for m in self.per_layer())

    def readers(self):
        """(entry, module) of the per-layer metrics this cell reports."""
        out = []
        for m in self.per_layer():
            spec = importlib.util.spec_from_file_location(
                "benchmark_metric_" + m["name"].replace(".", "_"),
                HERE / "metrics" / f"{m['name']}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out.append((m, mod))
        return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """One run: ``setup()``, ``window(seconds)`` or ``traced()``, then
    ``release()`` and ``check()``."""

    def __init__(self, cell, seed, device="cuda", t_start=None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.stages = {}
        self.rec = {}            # what the program's checked calls showed

    # ------------------------------------------------------------ set-up

    def setup(self):
        from sgs_gnn_tpu_torch.core.config import Config
        from sgs_gnn_tpu_torch.data.registry import HostDataset
        from sgs_gnn_tpu_torch.run import driver
        cell = self.cell
        cfg = Config(**cell.flags())
        self.cfg = cfg
        self.inputs = datagen.make_inputs(cell.graph, self.seed)
        x, ei, y, (tr, va, te), prior = self.inputs
        ds = HostDataset(name="SyntheticReddit", x=x, edge_index=ei, y=y,
                         train_mask=tr, val_mask=va, test_mask=te,
                         prob=prior, num_classes=int(y.max()) + 1,
                         He=float("nan"))
        orig = driver.induced_subgraphs

        def recording(*args, **kwargs):
            self.part, self.num_parts = np.asarray(args[6]), int(args[7])
            return orig(*args, **kwargs)
        t0 = time.perf_counter()
        driver.induced_subgraphs = recording
        try:
            batches, q, _ = driver.prepare_batches(cfg, ds, self.device)
        finally:
            driver.induced_subgraphs = orig
        sync(self.device)
        self.stages["data"] = time.perf_counter() - t0
        self.batches, self.q = batches, q
        n = len(batches)
        self.valid_e = [int(g.edge_mask.sum()) for g in batches]
        self.real_n = np.bincount(self.part, minlength=self.num_parts)[:n]
        has_train = [bool(g.train_mask.any()) for g in batches]
        self.plan = [0 if not has_train[i] else
                     (2 if self.valid_e[i] > q else 1) for i in range(n)]
        self.small = [int(v <= q) for v in self.valid_e]
        self.members = schedule.class_members([g.num_edges for g in batches])
        self.batch_plan = self.plan_facts()
        self._model()
        t1 = time.perf_counter()
        if cell.traffic["loop"] == "train_epochs":
            self._setup_train()
        else:
            self._setup_serve()
        sync(self.device)
        self.stages["capture"] = time.perf_counter() - t1
        self.setup_s = time.perf_counter() - self.t_start

    def _model(self):
        from sgs_gnn_tpu_torch.models import get_model
        cfg = self.cfg
        model = get_model(cfg.GNN, self.batches[0].x.shape[1], cfg.nhid,
                          self.batches[0].num_classes, cfg.drop_rate,
                          cfg.edge_mlp_type, heads=cfg.gat_heads,
                          dtype=cfg.dtype, device=self.device,
                          generator=torch.Generator().manual_seed(0))
        self.num_classes = self.batches[0].num_classes
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        self.weights = make_weights(shapes, self.seed, self.device)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(self.weights[k])
        self.model = model

    def seed_of(self, n):
        return schedule.batch_seed(self.seed, 0, n)

    def _setup_train(self):
        from sgs_gnn_tpu_torch.core import graphed
        from sgs_gnn_tpu_torch.eval import make_scan_eval_step
        from sgs_gnn_tpu_torch.train import (DualOptimizer,
                                             make_scan_epoch_step)
        from sgs_gnn_tpu_torch.train import pipelines
        cfg = self.cfg
        self.opt = DualOptimizer.create(self.model, cfg.GNN, cfg.lr,
                                        cfg.weight_decay)
        classes = graphed.ShapeClasses()
        self.steps = make_scan_epoch_step(cfg, self.model, self.opt, self.q,
                                          cfg.epochs, len(self.batches),
                                          classes)
        self.evals = make_scan_eval_step(cfg, self.model, self.q, classes)
        self.gen = torch.Generator(device=self.device)
        self.shuffle = np.random.default_rng(datagen.fold_seed(self.seed))
        order = schedule.epoch_order(self.shuffle, self.members)
        n_check = self.cell.traffic["checked_steps"]
        # the first steps of the first epoch, small ones included
        checked = [bi for bi in order if self.plan[bi]][:n_check]
        head = order[:order.index(checked[-1]) + 1]
        calls, static = [], {}
        orig = pipelines.sample_edges

        def recording(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls.append(out[0])
            return out
        pipelines.sample_edges = recording
        rec = dict(batches=checked, losses=[], gates=[], winners=[])
        try:
            for bi in head:
                key = (self.steps.classes.slot(self.batches[bi])[0].key,
                       self.plan[bi])
                c0 = len(calls)
                edge_before = self._edge_count()
                loss, _, _ = self.steps(self.batches, [bi], self.plan, 0,
                                        self.gen, self.seed_of)
                new = calls[c0:]
                if len(new) == 2:
                    static[key] = new[1]
                if bi not in checked:
                    continue
                rec["losses"].append(float(loss))
                rec["gates"].append(self._edge_count() - edge_before)
                w = None
                if self.mode_learned and self.plan[bi] == 2:
                    w = new[0] if new else static[key]
                    w = torch.sort(w).values.cpu()
                rec["winners"].append(w)
                if len(rec["losses"]) == 1:
                    rec["grad1"] = self._optimizer_grads()
        finally:
            pipelines.sample_edges = orig
        rec["params"] = {k: p.detach().cpu().clone()
                         for k, p in self.model.named_parameters()}
        self.rec = rec
        rest = order[len(head):]
        loss_acc, cond_acc, _ = self.steps(self.batches, rest, self.plan, 0,
                                           self.gen, self.seed_of)
        torch.stack([loss_acc, cond_acc]).tolist()
        self._eval(0)
        self.epoch = 1

    @property
    def mode_learned(self):
        return self.cell.mode == "learned"

    def _edge_count(self):
        st = self.opt.state.get("edge")
        return 0 if st is None else int(st.count)

    def _optimizer_grads(self):
        """The first gradient as the optimizer took it: Adam's first
        moment after one step is (1 - b1) g. Per leaf from the gnn group,
        else the edge group if it stepped, else the 'all' group (whose g
        holds the weight decay); None where no group moved."""
        opt, out = self.opt, {}
        for i, name in enumerate(opt.names):
            m = None
            for grp in ("gnn", "edge", "all"):
                st = opt.state.get(grp)
                if st is None or st.mu[i] is None:
                    continue
                if grp == "edge" and int(st.count) == 0:
                    continue
                m = st.mu[i]
                break
            out[name] = None if m is None else (m / (1.0 - opt.b1)).cpu()
        return out

    def _eval(self, epoch):
        from sgs_gnn_tpu_torch.eval import aggregate_eval
        res = self.evals(self.batches, self.small, self.gen,
                         schedule.batch_seed(self.seed, 0,
                                             schedule.EVAL_STREAM + epoch))
        self.last_eval = (epoch, res)     # device sums, read after release
        return aggregate_eval([res])

    def _setup_serve(self):
        from sgs_gnn_tpu_torch.run.serve import make_predictor
        self.predict = make_predictor(self.cfg, self.model, self.q)
        self.gen = torch.Generator(device=self.device)
        for j, members in enumerate(self.members):
            for rep in range(2):
                self.gen.manual_seed(schedule.batch_seed(self.seed, 2,
                                                         2 * j + rep))
                self.predict(self.batches[members[0]], self.gen)
        rng = np.random.default_rng([datagen.fold_seed(self.seed), 7])
        self.rr = [int(p) for p in rng.permutation(len(self.batches))]
        t = self.cell.traffic
        self.keep = set(int(i) for i in rng.choice(t["kept_from"],
                                                   t["kept_requests"],
                                                   replace=False))

    # ------------------------------------------------------------ window

    def window(self, seconds):
        """The measured window: the cell's end-to-end metrics by the host
        clock."""
        if self.cell.traffic["loop"] == "train_epochs":
            return self._train_window(seconds=seconds)
        return self._serve_window(seconds=seconds)

    def _train_window(self, seconds=None, epochs=None):
        trained = [bi for bi in range(len(self.batches)) if self.plan[bi]]
        edges_per_epoch = sum(self.valid_e[bi] for bi in trained)
        t0 = time.perf_counter()
        done = eval_s = 0.0
        n_epochs = 0
        while True:
            order = schedule.epoch_order(self.shuffle, self.members)
            with trace.span(torch, "train_epoch"):
                loss_acc, cond_acc, _ = self.steps(
                    self.batches, order, self.plan, self.epoch, self.gen,
                    self.seed_of)
            with trace.span(torch, "loss_readback"):
                torch.stack([loss_acc, cond_acc]).tolist()
            te = time.perf_counter()
            with trace.span(torch, "eval"):
                self._eval(self.epoch)
            eval_s += time.perf_counter() - te
            self.epoch += 1
            n_epochs += 1
            done = time.perf_counter() - t0
            if (epochs is not None and n_epochs >= epochs) or \
                    (seconds is not None and done >= seconds):
                break
        self.attempted = n_epochs * len(trained)
        self.window_facts = dict(epochs=n_epochs, steps=n_epochs
                                 * len(trained), evals=n_epochs
                                 * len(self.batches), seconds=done,
                                 eval_s=eval_s)
        return {"train_edges_per_s": n_epochs * edges_per_epoch / done}

    def _serve_window(self, seconds=None, requests=None):
        lat, kept = [], []
        t0 = time.perf_counter()
        i = 0
        while True:
            p = self.rr[i % len(self.rr)]
            self.gen.manual_seed(schedule.batch_seed(self.seed,
                                                     schedule.SERVE_RUN, i))
            ts = time.perf_counter()
            with trace.span(torch, "request"):
                logits, _ = self.predict(self.batches[p], self.gen)
                sync(self.device)
            lat.append(time.perf_counter() - ts)
            if i in self.keep:
                kept.append((i, p, logits))
            i += 1
            done = time.perf_counter() - t0
            if (requests is not None and i >= requests) or \
                    (seconds is not None and done >= seconds):
                break
        self.kept = kept
        self.attempted = i
        self.window_facts = dict(requests=i, seconds=done,
                                 parts=[self.rr[j % len(self.rr)]
                                        for j in range(i)])
        return {"serve_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def traced(self):
        """The traced stretch (whole epochs, or a number of requests) and
        the per-layer metrics its readers find."""
        t = self.cell.traffic
        if t["loop"] == "train_epochs":
            fn = lambda: self._train_window(epochs=t["trace_epochs"])
        else:
            fn = lambda: self._serve_window(requests=t["trace_requests"])
        tr = trace.traced(torch, fn)
        self.trace = tr
        ctx = dict(trace=tr, facts=self.window_facts, cell=self.cell,
                   stages=self.stages, shapes=self.shapes(),
                   program=tr.program,
                   log=lambda msg: print(msg, flush=True))
        out = {}
        for m, mod in self.cell.readers():
            v = mod.read(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def plan_facts(self):
        """The batches as the data layer built them: parts, q, padded
        nodes, the shape classes (parts x padded edges x tile slots), the
        valid edges and the parts of each case."""
        b = self.batches
        return dict(parts=len(b), q=self.q, nodes=b[0].num_nodes,
                    classes=[[len(m), b[m[0]].num_edges,
                              b[m[0]].tile_ls.shape[0] if b[m[0]].tile_t
                              else 0] for m in self.members],
                    valid_edges=[min(self.valid_e), max(self.valid_e)],
                    sampled=self.plan.count(2), small=self.plan.count(1),
                    skipped=self.plan.count(0))

    def shapes(self):
        """Per batch: real nodes, valid edges; and q, the draws."""
        return dict(n=[int(v) for v in self.real_n], e=list(self.valid_e),
                    q=self.q, plan=list(self.plan),
                    draws=self.cell.traffic["num_samples_eval"])

    # ------------------------------------------------------------- check

    def release(self):
        """Read the peak, keep host copies of the program's batches the
        check reads, and free the program's state."""
        if self.device.type == "cuda":
            self.peak = int(torch.cuda.max_memory_allocated(self.device))
        else:
            self.peak = 0
        need = (self.rec.get("batches", []) if hasattr(self, "steps")
                else sorted({p for _, p, _ in self.kept}))
        # what the partition check reads of every batch, and the last
        # eval with the parameters it ran on (nothing trains after it)
        self.split_counts = [[int(getattr(g, f"{s}_mask").sum())
                              for s in compare.SPLITS] for g in self.batches]
        if hasattr(self, "last_eval"):
            epoch, res = self.last_eval
            self.eval_rec = dict(
                epoch=epoch, sums={k: float(v) for k, v in res.items()},
                params={k: p.detach().float().cpu()
                        for k, p in self.model.named_parameters()})
            del self.last_eval
        self.prog_batches = {bi: compare.batch_arrays(self.batches[bi])
                             for bi in need}
        self.shapes_of = {bi: (self.batches[bi].num_nodes,
                               self.batches[bi].num_edges,
                               0 if not self.batches[bi].tile_t else
                               self.batches[bi].tile_ls.shape[0])
                          for bi in range(len(self.batches))}
        if hasattr(self, "kept"):
            self.kept = [(i, p, l.detach().cpu()) for i, p, l in self.kept]
        for name in ("steps", "evals", "opt", "predict", "batches", "model"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision=None, control=False):
        """The numbers compared, from the reference (``precision`` its
        rounding); ``control``: the reference in the lower precision takes
        the program's place."""
        return compare.check(self, precision, control)

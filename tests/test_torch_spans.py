"""The port's spans, counters and device stamps (``core/spans.py``) on the
CPU.

  * Off (the default), nothing is recorded, and the graphed epoch, eval and
    ``predict`` (a fake capture whose replay reruns the body, as in
    tests/test_torch_graphed.py) give the same outputs, bit for bit, as
    with spans and stamps on.
  * Nesting: parents, ids, total and self time; ``reset``.
  * Counters at each boundary: the graphs' eager runs, captures, replays
    and loaded bytes, the data layer's spans and bytes, the kernel
    library's build; the launch counters are ``ops/_build``'s.
  * A stamp does nothing on the CPU and loads no library; ``boundary`` is
    an identity for the gradient.
  * ``label_gaps`` on a synthetic profiler stretch: fed the harness's
    spans it gives ``benchmark/trace.py``'s idle gaps, fed the program's
    it labels each gap once, and both sum to the same idle seconds.
  * ``--gpu_profile`` on the CPU closes the log with the tables.
"""
import collections
import contextlib
import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from sgs_gnn_tpu_torch import get_model, make_predictor
from sgs_gnn_tpu_torch.core import Config, graphed, spans
from sgs_gnn_tpu_torch.data import registry as treg
from sgs_gnn_tpu_torch.eval import make_scan_eval_step
from sgs_gnn_tpu_torch.ops import _build
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.train import DualOptimizer, make_scan_epoch_step

ROOT = Path(__file__).resolve().parents[1]
HID = 16
BASE = dict(dataset="SyntheticSBM", metis_threshold=20000, shape_classes=2,
            nhid=HID, runs=1, num_samples_eval=3)
LEARNED = dict(mode="learned", pipeline="hybrid", conditional=True,
               reg1=True, reg2=True, sparse_edge_mlp=True)


@pytest.fixture(autouse=True)
def spans_off_after():
    """Each test starts and ends with the module off and empty, one torch
    thread and float32 (tests/test_reference_oracle.py sets float64)."""
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


class _Rerun:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.last = self.fn()


class _RerunOut(graphed.Captured):
    def replay(self):
        super().replay()
        return self.graph.last


def _rerun_capture(fn, pool=None, generators=()):
    """A fake capture: its replay reruns the body and hands out the fresh
    outputs as the static ones."""
    return _RerunOut(_Rerun(fn), None, collections.Counter(),
                     collections.Counter(), generators)


@pytest.fixture(scope="module")
def parts():
    """4 partitions in 2 shape classes; a skipped, a small and two sampled
    batches, q below every sampled batch's valid edges."""
    cfg = Config(**BASE)
    ds = treg.get_dataset(cfg)
    batches, _, _ = driver.prepare_batches(cfg, ds, "cpu")
    valid = [int(g.edge_mask.sum()) for g in batches]
    plan = [0, 1, 2, 2]
    q = min(v for v, a in zip(valid, plan) if a == 2) // 3
    return batches, plan, q, ds.num_classes


def _model(cfg, batches, classes, seed=1):
    return get_model("GCN", batches[0].x.shape[1], HID, classes,
                     cfg.drop_rate, "GCN", device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _graphed_epochs(parts, kw, epochs=2, loop=False):
    """Train ``epochs`` graphed epochs (fake capture; with ``loop`` on the
    loop route) and eval after each; the loss sums, F1 sums and
    parameters."""
    batches, plan, q, classes = parts
    cfg = Config(**dict(BASE, **kw))
    tm = _model(cfg, batches, classes)
    opt = DualOptimizer.create(tm, "GCN", cfg.lr, cfg.weight_decay)
    pool = graphed.ShapeClasses(new_pool=lambda: None)
    steps = make_scan_epoch_step(cfg, tm, opt, q, 3, len(batches), pool,
                                 loop)
    evals = make_scan_eval_step(cfg, tm, q, pool, loop)
    if not loop:
        steps.graphs = graphed.Graphs(_rerun_capture, name="step")
        evals.graphs = graphed.Graphs(_rerun_capture, name="eval")
    gen = torch.Generator()
    out = []
    for epoch in range(epochs):
        acc = steps(batches, [3, 0, 1, 2], plan, epoch, gen,
                    lambda n: driver.batch_seed(0, 0, n))
        out.append([float(v) for v in acc])
        res = evals(batches, [1, 0, 1, 0], gen, 7 + epoch)
        out.append([float(res[k]) for k in sorted(res)])
    return out, [p.detach().clone() for p in tm.parameters()]


def _predict(parts, monkeypatch):
    monkeypatch.setattr(graphed, "runs_graphs", lambda device: True)
    monkeypatch.setattr(graphed, "capture", _rerun_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    batches, _, q, classes = parts
    cfg = Config(**BASE)
    predict = make_predictor(cfg, _model(cfg, batches, classes, 2), q)
    gen = torch.Generator()
    out = [predict(batches[i], gen.manual_seed(s))
           for i, s in ((2, 1), (3, 2), (2, 1))]
    return [t for pair in out for t in pair]


def test_off_is_one_shared_nullcontext_and_records_nothing(parts):
    assert not spans.ON and not spans.STAMPS
    a, b = spans.span("x"), spans.span("y", id=3)
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert spans.phase("step") is a
    spans.count("c", 5)
    spans.stamp("scorer", "cpu")
    x = torch.ones(3, requires_grad=True)
    assert spans.boundary(x, "backbone") is x
    _graphed_epochs(parts, LEARNED, epochs=1)
    got = spans.collect()
    assert got["spans"] == {} and got["records"] == []
    assert got["segments"] == {}
    assert not any(not k.startswith("kernels.") for k in got["counters"])


@pytest.mark.parametrize("kw", [LEARNED, dict(mode="random")],
                         ids=["hybrid_rescore", "random"])
def test_graphed_epoch_is_the_same_with_spans_and_stamps_on(parts, kw):
    off = _graphed_epochs(parts, kw)
    spans.enable(device_stamps=True)
    on = _graphed_epochs(parts, kw)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)
    assert spans.collect()["spans"]["step"]["calls"] == 2 * 3


def test_loop_route_opens_the_schedule_spans_but_no_slot_or_load(
        parts, monkeypatch):
    """The loop route: the same outputs and the same stamps, in order and
    by name, as the graphed route, the ``step`` and ``eval`` spans per
    batch and call, and no buffers, loads, graphs or replays."""
    names = []
    monkeypatch.setattr(spans, "_launch",
                        lambda name, device: names.append(name))
    spans.enable(device_stamps=True)
    graphed_out = _graphed_epochs(parts, LEARNED)
    graphed_names = list(names)
    assert "step.backbone" in graphed_names
    assert "eval.backbone" in graphed_names
    spans.reset()
    names.clear()
    loop_out = _graphed_epochs(parts, LEARNED, loop=True)
    assert names == graphed_names
    assert loop_out[0] == graphed_out[0]
    for a, b in zip(loop_out[1], graphed_out[1]):
        assert torch.equal(a, b)
    got = spans.collect()
    assert got["spans"]["step"]["calls"] == 2 * 3
    assert got["spans"]["eval"]["calls"] == 2
    assert got["spans"]["eval.batch"]["calls"] == 2 * 4
    for name in ("step", "eval"):
        for part in ("slot", "load", "replay"):
            assert f"{name}.{part}" not in got["spans"]
    assert not any(k.startswith("graph.") for k in got["spans"])
    assert not any(k.startswith("graph.") for k in got["counters"])


def test_predict_is_the_same_with_spans_and_stamps_on(parts, monkeypatch):
    off = _predict(parts, monkeypatch)
    spans.enable(device_stamps=True)
    on = _predict(parts, monkeypatch)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    got = spans.collect()
    assert got["spans"]["serve.request"]["calls"] == 3
    assert got["spans"]["serve.replay"]["calls"] == 2
    assert got["spans"]["serve.clone"]["calls"] == 2
    assert [r[1] for r in got["records"] if r[0] == "serve.request"] == \
        [0, 1, 2]


def test_nesting_parents_ids_and_self_time():
    spans.enable()
    with spans.span("outer", id=(1, 2)):
        time.sleep(0.02)
        with spans.span("inner", id=0):
            time.sleep(0.03)
        with spans.span("inner", id=1):
            with spans.span("leaf"):
                time.sleep(0.01)
    with spans.span("after"):
        pass
    got = spans.collect()
    recs = got["records"]
    by = {(r[0], r[1]): i for i, r in enumerate(recs)}
    assert [r[0] for r in recs] == ["outer", "inner", "inner", "leaf",
                                    "after"]
    assert recs[by["outer", (1, 2)]][2] is None
    assert recs[by["inner", 0]][2] == by["outer", (1, 2)]
    assert recs[by["inner", 1]][2] == by["outer", (1, 2)]
    assert recs[by["leaf", None]][2] == by["inner", 1]
    assert recs[by["after", None]][2] is None
    s = got["spans"]
    assert s["inner"]["calls"] == 2
    total = {r[0]: 0 for r in recs}
    for r in recs:
        total[r[0]] += r[4] - r[3]
    assert s["outer"]["total_s"] == pytest.approx(total["outer"] / 1e9)
    assert s["outer"]["self_s"] == pytest.approx(
        (total["outer"] - total["inner"]) / 1e9)
    assert s["inner"]["self_s"] == pytest.approx(
        (total["inner"] - total["leaf"]) / 1e9)
    assert s["leaf"]["self_s"] == s["leaf"]["total_s"] >= 0.01
    assert 0.02 <= s["outer"]["self_s"] < s["outer"]["total_s"]
    lines = spans.report_lines(got)
    assert lines[0].startswith("[spans] inner ")     # largest self time


def test_reset_forgets_and_drops_spans_open_across_it():
    spans.enable()
    spans.count("a", 2)
    with spans.span("open"):
        spans.reset()
        with spans.span("kept"):
            spans.count("b")
    got = spans.collect()
    assert set(got["spans"]) == {"kept"}
    assert got["records"][0][2] is None
    assert got["counters"] == {"b": 1}


def test_counters_at_the_graphs_and_the_launch_counters():
    """``Graphs`` under the fake capture context of
    tests/test_torch_graphed.py: one eager run and capture, then replays,
    counted; ``LAUNCHES`` and ``ROUTES`` are ``ops/_build``'s and read as
    before, the capture's tally added back on each replay."""
    assert _build.LAUNCHES is spans.LAUNCHES
    assert _build.ROUTES is spans.ROUTES

    class _FakeGraph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    def fake_capture(fn, pool=None, generators=()):
        return graphed.capture(fn, pool, generators, graph=_FakeGraph(),
                               context=lambda g, p: contextlib.nullcontext())

    def body(generator):
        _build.LAUNCHES["scatter_add"] += 2
        _build.ROUTES["scatter_add", "slab"] += 2
        return "out"
    spans.enable()
    launches0 = collections.Counter(_build.LAUNCHES)
    routes0 = collections.Counter(_build.ROUTES)
    graphs = graphed.Graphs(fake_capture, name="step")
    for _ in range(4):
        assert graphs.run("k", body, None) == "out"
    assert graphs.replays == 3 and len(graphs) == 1
    assert _build.LAUNCHES - launches0 == {"scatter_add": 8}
    assert _build.ROUTES - routes0 == {("scatter_add", "slab"): 8}
    got = spans.collect()
    c = got["counters"]
    assert c["graph.eager_runs"] == 1 and c["graph.captures"] == 1
    assert c["graph.replays"] == 3
    assert c["kernels.launches.scatter_add"] == 8
    assert c["kernels.routes.scatter_add.slab"] == 8
    assert {k: v["calls"] for k, v in got["spans"].items()} == {
        "graph.eager": 1, "graph.capture": 1, "step.replay": 3}


def test_the_aggregation_route_counter():
    """``spmm(backend="auto")`` counts each call on the route it took in
    ``ROUTES`` ("gather_k1" on the CPU, with or without gradients), which
    ``collect`` reports as ``kernels.routes.spmm.<route>``; a counter
    that did not move since ``reset`` is left out."""
    from sgs_gnn_tpu_torch.ops import spmm
    x = torch.randn(10, 4).to(torch.bfloat16)
    s = torch.tensor([0, 1, 2, 9], dtype=torch.int32)
    r = torch.tensor([1, 1, 2, 0], dtype=torch.int32)
    spmm(s, r, None, x, 10)
    spans.enable()
    spans.reset()
    with torch.no_grad():
        spmm(s, r, torch.ones(4), x, 10)
    spmm(s, r, None, x.clone().requires_grad_(), 10)
    c = spans.collect()["counters"]
    assert {k: v for k, v in c.items() if k.startswith("kernels.routes.")} \
        == {"kernels.routes.spmm.gather_k1": 2}


def test_counters_at_the_data_epoch_eval_and_kernel_boundaries(
        parts, monkeypatch, tmp_path):
    spans.enable()
    cfg = Config(**dict(BASE, **LEARNED, tile_index="on"))
    ds = treg.get_dataset(cfg)
    batches, _, _ = driver.prepare_batches(cfg, ds, "cpu")
    got = spans.collect()
    s, c = got["spans"], got["counters"]
    n = len(batches)
    assert s["data.prepare"]["calls"] == s["data.partition"]["calls"] == 1
    assert s["data.induce"]["calls"] == 1
    assert s["data.tiles"]["calls"] == s["data.to_device"]["calls"] == n
    nbytes = sum(v.nbytes for g in batches
                 for v in graphed.graph_tensors(g).values())
    # the padded tile arrays are made on the device after the copy
    assert 0 < c["data.bytes_to_device"] <= nbytes
    parent = {i: r for i, r in enumerate(got["records"])}
    for r in got["records"]:
        if r[0] in ("data.partition", "data.induce"):
            assert parent[r[2]][0] == "data.prepare"
        if r[0] == "data.tiles":
            assert parent[r[2]][0] == "data.induce"

    spans.reset()
    batches, plan, q, classes = parts
    _graphed_epochs(parts, LEARNED, epochs=2)
    got = spans.collect()
    s, c = got["spans"], got["counters"]
    trained = sum(map(bool, plan))
    # one graph per (class, case) of the train and of the eval
    graphs = len({(batches[i].num_edges, a) for i, a in enumerate(plan)
                  if a}) + len({(g.num_edges, f) for g, f in
                                zip(batches, [1, 0, 1, 0])})
    assert s["step"]["calls"] == s["step.load"]["calls"] == 2 * trained
    assert s["eval"]["calls"] == 2
    assert s["eval.batch"]["calls"] == s["eval.load"]["calls"] == 2 * 4
    assert c["graph.eager_runs"] == c["graph.captures"] == graphs
    assert c["graph.replays"] == 2 * (trained + 4) - graphs
    assert s["step.replay"]["calls"] + s["eval.replay"]["calls"] == \
        c["graph.replays"]
    per_batch = {g.num_edges: sum(v.nbytes for v in
                                  graphed.graph_tensors(g).values())
                 for g in batches}
    want = 2 * sum(per_batch[batches[i].num_edges] for i in range(4)
                   if plan[i]) + 2 * sum(per_batch[g.num_edges]
                                         for g in batches)
    assert c["graph.load_bytes"] == want
    for r in got["records"]:
        if r[0] in ("step.slot", "step.load", "step.replay"):
            assert got["records"][r[2]][0] == "step"
        if r[0] == "step":
            assert isinstance(r[1], tuple) and r[1][1] in (1, 2, 3)

    spans.reset()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "source_hash", lambda: "test")
    monkeypatch.setattr(_build, "_compile",
                        lambda lib: Path(lib).write_bytes(b""))
    lib = _build.build()
    assert _build.build() == lib          # present: not built again
    got = spans.collect()
    assert got["counters"] == {"kernels.builds": 1}
    assert got["spans"]["kernels.build"]["calls"] == 1


def test_stamp_does_nothing_on_the_cpu(monkeypatch):
    def no_library():
        raise AssertionError("a CPU stamp loaded the kernel library")
    monkeypatch.setattr(_build, "library", no_library)
    spans.enable(device_stamps=True)
    for seg in ("between", "scorer", "optimizer"):
        spans.stamp(seg, "cpu")
        spans.stamp(seg, torch.device("cpu"))
    with spans.phase("step"):
        spans.stamp("backbone", "cpu")
    assert spans.collect()["segments"] == {}


def test_boundary_is_an_identity_for_the_gradient():
    x = torch.linspace(-1, 1, 7, requires_grad=True)
    w = torch.arange(7.0)
    spans.enable(device_stamps=True)
    y = spans.boundary(x, "backbone")
    assert y is not x and torch.equal(y, x)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)
    frozen = torch.ones(3)
    assert spans.boundary(frozen, "backbone") is frozen
    spans.disable()
    assert spans.boundary(x, "backbone") is x


def _trace_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_trace_for_spans", ROOT / "benchmark" / "trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, start, end, device):
    from torch.autograd import DeviceType
    rng = SimpleNamespace(start=start, end=end,
                          elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, time_range=rng,
                           device_type=DeviceType.CUDA if device
                           else DeviceType.CPU)


def test_label_gaps_puts_each_idle_gap_down_once():
    """A synthetic profiled stretch (microseconds): the harness's window
    and phase spans, the program's spans, and kernels with five idle gaps
    (0-50, 200-210, 290-360, 500-650, 800-1000). Fed the harness's spans,
    ``label_gaps`` gives ``benchmark/trace.py``'s ``gaps``; fed the
    program's, it puts each gap down once, and both sum to the same idle
    seconds."""
    host = [("bench.window", 0, 1000), ("bench.train_epoch", 10, 600),
            ("bench.eval", 600, 990),
            ("sgs.step", 20, 300), ("sgs.step.load", 20, 40),
            ("sgs.step.replay", 40, 60), ("sgs.step", 320, 580),
            ("sgs.step.replay", 330, 350), ("sgs.eval", 610, 880)]
    kernels = [("k1", 50, 200), ("k2", 210, 290), ("k1", 360, 500),
               ("k3", 650, 700), ("k3", 700, 800)]
    events = [_event(n, a, b, False) for n, a, b in host]
    events += [_event(n, a, b, True) for n, a, b in kernels]
    events.append(_event("bench.train_epoch", 50, 500, True))
    trace = _trace_module()

    class _Prof:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    fake = SimpleNamespace(
        cuda=SimpleNamespace(synchronize=lambda: None),
        profiler=SimpleNamespace(
            record_function=lambda name: contextlib.nullcontext(),
            profile=_Prof))
    real = torch.profiler.profile
    try:
        torch.profiler.profile = _Prof
        tr = trace.traced(fake, lambda: None)
    finally:
        torch.profiler.profile = real
    busy = trace._union((a, b) for _, a, b in kernels)
    assert tr.busy_s == pytest.approx(sum(b - a for a, b in busy) / 1e6)
    bench = [(n[len("bench."):], a, b) for n, a, b in host
             if n.startswith("bench.")]
    prog = [(n[len(spans.PREFIX):], a, b) for n, a, b in host
            if n.startswith(spans.PREFIX)]
    harness = spans.label_gaps(busy, bench, 0, 1000)
    assert harness == pytest.approx(tr.gaps)
    assert harness == pytest.approx({"train_epoch": 280e-6,
                                     "eval": 200e-6})
    program = spans.label_gaps(busy, prog, 0, 1000)
    assert program == pytest.approx({"step.load": 50e-6, "step": 230e-6,
                                     "outside": 200e-6})
    assert sum(program.values()) == pytest.approx(sum(harness.values()))
    assert sum(harness.values()) == pytest.approx(
        (1000 - 0) / 1e6 - tr.busy_s)
    # without lo and hi only the gaps between busy intervals count
    assert spans.label_gaps(busy, prog) == pytest.approx(
        {"step": 230e-6})


def test_gpu_profile_closes_the_log_with_the_tables(tmp_path):
    lines = []
    cfg = Config(dataset="Karate", mode="learned", epochs=2, runs=1,
                 gpu_profile=True, results_dir=str(tmp_path),
                 save_csv=False)
    driver.run_experiment(cfg, log_fn=lines.append, device="cpu")
    assert not spans.ON                      # turned off after the run
    names = {ln.split()[1] for ln in lines if ln.startswith("[spans]")}
    assert {"run.epoch", "run.readback", "run.eval", "run.best_model",
            "data.prepare", "data.to_device"} <= names
    assert any(ln.startswith("[counters] data.bytes_to_device=")
               for ln in lines)
    assert not any(ln.startswith("[stamps]") for ln in lines)   # the CPU

"""Each architecture's plain reference and frozen count in a module of its
own (``benchmark/archs/``), and the program's record in the traced
stretch.

  * The reference's outputs and the frozen counts of the four cells are
    pinned to values recorded before the architectures moved into their
    modules, and held to them exactly. The reference is driven alone, on
    batches it builds itself from the benchmark's inputs (one part a
    community), so nothing of the program's run reaches the pins.
  * A configuration whose backbone or scorer has no module raises and
    names the file to add; a module placed in another directory is found
    and its forward and count are the ones used.
  * ``benchmark/trace.py`` on a synthetic profiled stretch: the program's
    annotations and its stamp kernel stay out of the kernels and the busy
    union, and the program's gaps are labelled by its host spans.
"""
import contextlib
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import archs, counts, datagen, harness
from benchmark import reference as R
from benchmark import trace
from benchmark.tests.cpu import SMALL_FLAGS, SMALL_GRAPH

CELLS = ["gcn_reddit.train_learned", "gat_gsage_reddit.train_learned",
         "gcn_reddit.serve_predict", "gcn_reddit.train_random"]
PIN_SEED = 2 ** 31 + 23


def _cell(name, **flags):
    return harness.Cell(name, graph=SMALL_GRAPH,
                        flags=dict(SMALL_FLAGS, **flags))


def _shapes(cfg):
    """The program's parameter names and shapes, in its order (the names
    the reference reads)."""
    from sgs_gnn_tpu_torch.models import get_model
    model = get_model(cfg["GNN"], cfg["num_features"], cfg["nhid"],
                      cfg["num_classes"], cfg["drop_rate"],
                      cfg["edge_mlp_type"], heads=cfg["gat_heads"],
                      device="cpu", generator=torch.Generator().manual_seed(0))
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _batch(cell):
    """Part 0 of the small graph (its first community), padded by one
    ghost node and to its own edge count, with the tile index."""
    inputs = datagen.make_inputs(cell.graph, PIN_SEED)
    n = inputs[0].shape[0]
    part = np.arange(n) * cell.graph["communities"] // n
    max_n = int(np.bincount(part).max()) + 1
    ei = inputs[1]
    e = int(((part[ei[0]] == 0) & (part[ei[1]] == 0)).sum())
    return R.to_device(R.build_batch(inputs, part, 0, max_n, e + 8), "cpu")


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _gen(k):
    return torch.Generator().manual_seed(PIN_SEED + k)


def reference_outputs(name, precision, **flags):
    """What the reference computes for a cell on the pinned batch, each
    output as a digest of its bytes (losses as the float's hex): the
    checked step's loss and gradients (learned, small, random), the
    predicted logits and the eval's counts."""
    cell = _cell(name, **flags)
    cfg = cell.ref_cfg()
    pr = (R.F32 if precision == "float32"
          else R.Precision(getattr(torch, precision)))
    P = {k: v.requires_grad_(True) for k, v in R.make_weights(
        _shapes(cfg), PIN_SEED, "cpu").items()}
    params = list(P.values())
    model = R.Model(cfg, P, pr)
    g = _batch(cell)
    q = int(g["edge_mask"].sum()) // 5
    out = {}

    def step(key, total):
        grads = torch.autograd.grad(total, params, allow_unused=True)
        out[key + ".loss"] = float(total.detach()).hex()
        out[key + ".grads"] = _digest(*[torch.zeros(1) if gr is None else gr
                                        for gr in grads])
    if cell.mode == "learned" and cell.traffic["loop"] == "train_epochs":
        total, facts = R.learned_step(model, cfg, g, _gen(1), q, None, None)
        step("learned", total)
        out["learned.winners"] = _digest(facts["winners"])
        out["learned.gate"] = facts["gate"]
    elif cell.mode == "random":
        step("random", R.random_step(model, cfg, g, _gen(1), q)[0])
    step("small", R.small_step(model, cfg, g, _gen(2))[0])
    with torch.no_grad():
        out["predict"] = _digest(R.predict(model, cfg, g, _gen(3), q,
                                           cell.traffic["num_samples_eval"]))
        ev = R.evaluate(model, cfg, g, _gen(4), q,
                        cell.traffic["num_samples_eval"], cell.mode, False)
    out["eval"] = [list(ev[s]) for s in ("train", "val", "test")]
    return out


# recorded before the architectures moved into benchmark/archs/: (cell,
# the reference's precision, GAT's heads) -> outputs
REFERENCE_PINS = {
    ('gcn_reddit.train_learned', 'float32', 1): {
        'learned.loss': '0x1.fbcbbe0000000p+1',
        'learned.grads': '02adfa7ceb7db716',
        'learned.winners': 'ed89014ce6a5fd74',
        'learned.gate': False,
        'small.loss': '0x1.f395f80000000p+1',
        'small.grads': 'c3a1d930dae53940',
        'predict': 'c807db1e0d799678',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.train_learned', 'bfloat16', 1): {
        'learned.loss': '0x1.fbd0080000000p+1',
        'learned.grads': '43b2ccb1b3ac57b6',
        'learned.winners': 'e0e99c5d1ec3128e',
        'learned.gate': False,
        'small.loss': '0x1.f39d7a0000000p+1',
        'small.grads': '5d851fca5f5b943f',
        'predict': '06fe19b92e79e1b2',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.train_learned', 'float8_e4m3fn', 1): {
        'learned.loss': '0x1.ff55c80000000p+1',
        'learned.grads': '39ccea36361cd8d2',
        'learned.winners': '4eaaecb00cdf9925',
        'learned.gate': False,
        'small.loss': '0x1.f6a61a0000000p+1',
        'small.grads': '1ab3bab9ed34dde9',
        'predict': '34beeb137ef827f4',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gat_gsage_reddit.train_learned', 'float32', 1): {
        'learned.loss': '0x1.7e03b80000000p+2',
        'learned.grads': '5c67532c9703e583',
        'learned.winners': '9242344a70c219d8',
        'learned.gate': True,
        'small.loss': '0x1.0117a60000000p+2',
        'small.grads': '9d1d132ca2d643bc',
        'predict': 'd0a54683df8263b4',
        'eval': [[1, 203], [0, 53], [0, 44]],
    },
    ('gat_gsage_reddit.train_learned', 'bfloat16', 1): {
        'learned.loss': '0x1.78571a0000000p+2',
        'learned.grads': '433125ac478b11d8',
        'learned.winners': '4b76febcbfc34fff',
        'learned.gate': True,
        'small.loss': '0x1.0130580000000p+2',
        'small.grads': '63e872d8fb51a345',
        'predict': '75e75863b7ef9e48',
        'eval': [[1, 203], [0, 53], [0, 44]],
    },
    ('gat_gsage_reddit.train_learned', 'float8_e4m3fn', 1): {
        'learned.loss': '0x1.7e46040000000p+2',
        'learned.grads': '45850f601b9e5e45',
        'learned.winners': 'd62017360b816e69',
        'learned.gate': True,
        'small.loss': '0x1.fee7040000000p+1',
        'small.grads': '6c5377aa9a8dac97',
        'predict': 'ae2f10b8a49c39a0',
        'eval': [[1, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.serve_predict', 'float32', 1): {
        'small.loss': '0x1.f395f80000000p+1',
        'small.grads': 'c3a1d930dae53940',
        'predict': '2f46bdc381dd98de',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.serve_predict', 'bfloat16', 1): {
        'small.loss': '0x1.f39d7a0000000p+1',
        'small.grads': '5d851fca5f5b943f',
        'predict': '30c6e7189d5eef0f',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.serve_predict', 'float8_e4m3fn', 1): {
        'small.loss': '0x1.f6a61a0000000p+1',
        'small.grads': '1ab3bab9ed34dde9',
        'predict': '14e7baeb98497328',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.train_random', 'float32', 1): {
        'random.loss': '0x1.01bbba0000000p+2',
        'random.grads': 'd8218d7b3d5cb2bb',
        'small.loss': '0x1.f395f80000000p+1',
        'small.grads': 'c3a1d930dae53940',
        'predict': 'c807db1e0d799678',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.train_random', 'bfloat16', 1): {
        'random.loss': '0x1.01b77c0000000p+2',
        'random.grads': 'bd825a34d3aa294e',
        'small.loss': '0x1.f39d7a0000000p+1',
        'small.grads': '5d851fca5f5b943f',
        'predict': '06fe19b92e79e1b2',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gcn_reddit.train_random', 'float8_e4m3fn', 1): {
        'random.loss': '0x1.03b5780000000p+2',
        'random.grads': '3925818b411fc9f0',
        'small.loss': '0x1.f6a61a0000000p+1',
        'small.grads': '1ab3bab9ed34dde9',
        'predict': '34beeb137ef827f4',
        'eval': [[0, 203], [0, 53], [0, 44]],
    },
    ('gat_gsage_reddit.train_learned', 'float32', 2): {
        'learned.loss': '0x1.034eb40000000p+2',
        'learned.grads': '68eea05a91a76948',
        'learned.winners': '9242344a70c219d8',
        'learned.gate': False,
        'small.loss': '0x1.17ad400000000p+2',
        'small.grads': '2f445d33c0344662',
        'predict': 'e0e7c017fb855aee',
        'eval': [[1, 203], [0, 53], [0, 44]],
    },
    ('gat_gsage_reddit.train_learned', 'bfloat16', 2): {
        'learned.loss': '0x1.0322ba0000000p+2',
        'learned.grads': 'ee7909414038983e',
        'learned.winners': '4b76febcbfc34fff',
        'learned.gate': False,
        'small.loss': '0x1.173f240000000p+2',
        'small.grads': 'fe1a362cd09dea41',
        'predict': 'f9b532876c086b1d',
        'eval': [[1, 203], [1, 53], [0, 44]],
    },
}


@pytest.mark.parametrize("name,precision,heads", sorted(REFERENCE_PINS))
def test_the_reference_is_pinned(name, precision, heads):
    got = reference_outputs(name, precision, gat_heads=heads)
    assert got == REFERENCE_PINS[name, precision, heads]


def count_outputs(name):
    """The frozen counts of a cell at the full configuration's per-part
    shapes (~1,870 nodes, 0.7M valid edges, q 200,000)."""
    cell = harness.Cell(name)
    cfg, mode = cell.ref_cfg(), cell.mode
    n, e, q = 1870, 700_001, 200_000
    draws = cell.traffic["num_samples_eval"]
    out = dict(train=counts.train_step_flops(cfg, mode, n, e, q),
               eval=counts.eval_flops(cfg, mode, n, e, q, draws),
               head_train=counts.head_train_flops(cfg, e, q),
               head_eval=counts.head_eval_flops(cfg, e))
    if cfg["GNN"] == "GCN":
        out.update(rows_train=counts.rows_train_bytes(cfg, mode, n, e, q),
                   rows_eval=counts.rows_eval_bytes(cfg, mode, n, e, q,
                                                    draws))
    return out


# recorded before the architectures moved into benchmark/archs/
COUNT_PINS = {
    'gcn_reddit.train_learned': dict(
        train=346766980096,
        eval=186132181120,
        head_train=341453062656,
        head_eval=183859462656,
        rows_train=988404000,
        rows_eval=863282288,
    ),
    'gat_gsage_reddit.train_learned': dict(
        train=347268774856,
        eval=186592787880,
        head_train=341453062656,
        head_eval=183859462656,
    ),
    'gcn_reddit.serve_predict': dict(
        train=346766980096,
        eval=193476520320,
        head_train=341453062656,
        head_eval=183859462656,
        rows_train=988404000,
        rows_eval=2121647488,
    ),
    'gcn_reddit.train_random': dict(
        train=1508122880,
        eval=734433920,
        head_train=341453062656,
        head_eval=183859462656,
        rows_train=248458080,
        rows_eval=125836520,
    ),
}


@pytest.mark.parametrize("name", CELLS)
def test_the_counts_are_pinned(name):
    assert count_outputs(name) == COUNT_PINS[name]


# ------------------------------------------------------- the lookup

@pytest.mark.parametrize("flags,missing", [
    (dict(GNN="GIN"), "benchmark/archs/backbone_GIN.py"),
    (dict(GNN="Cheb"), "benchmark/archs/backbone_Cheb.py"),
    (dict(edge_mlp_type="MLP"), "benchmark/archs/scorer_MLP.py")])
def test_a_missing_architecture_names_the_file_to_add(flags, missing):
    cfg = dict(_cell("gcn_reddit.train_learned").ref_cfg(), **flags)
    model = R.Model(cfg, {})
    x = torch.zeros(3, cfg["num_features"])
    s = r = torch.zeros(2, dtype=torch.int32)
    if "GNN" in flags:
        calls = [lambda: model.forward(x, s, r, None, 3, None),
                 lambda: counts.backbone(cfg, 3, 2, True)]
    else:
        calls = [lambda: model.encode(x, s, r, 3, None),
                 lambda: counts.scorer_encoder(cfg, 3, 2, True)]
    for call in calls:
        with pytest.raises(NotImplementedError, match=missing):
            call()


def test_an_architecture_module_is_found_by_its_flags(tmp_path,
                                                      monkeypatch):
    """A backbone and a scorer that no configuration had, as files in
    another directory: the reference's forward and encode and the counts
    use what they define."""
    (tmp_path / "backbone_GIN.py").write_text(
        "def forward(m, x, s, r, w, n, gen):\n"
        "    return m.P['w'] * x.sum() + len(s)\n\n\n"
        "def count(cfg, n, e):\n"
        "    return 10 * n, 100 * e\n")
    (tmp_path / "scorer_MLP.py").write_text(
        "def encode(m, x, s, r, n, gen):\n"
        "    return x * m.P['w']\n\n\n"
        "def count(cfg, n, e):\n"
        "    return n + e, 0\n")
    monkeypatch.setattr(archs, "DIR", tmp_path)
    cfg = dict(_cell("gcn_reddit.train_learned").ref_cfg(), GNN="GIN",
               edge_mlp_type="MLP")
    half = R.Precision(torch.bfloat16)
    model = R.Model(cfg, {"w": torch.tensor(3.0)}, half)
    x = torch.tensor([[1.0, 2.0], [0.1, 0.2]])
    s = r = torch.zeros(5, dtype=torch.int32)
    assert float(model.forward(x, s, r, None, 2, None)) == \
        pytest.approx(3.0 * 3.3 + 5)
    # the embeddings come back rounded to the compute dtype
    assert torch.equal(model.encode(x, s, r, 2, None), half(x * 3.0))
    assert counts.backbone(cfg, 2, 7, False) == 20
    assert counts.backbone(cfg, 2, 7, True) == 720
    assert counts.scorer_encoder(cfg, 2, 7, True) == 9
    # a sampled learned step: the encoder on q edges, the head over e,
    # the head on q with its backward, the backbone twice with its own
    k, n, e, q = cfg["nhid"], 2, 50, 7
    assert counts.train_step_flops(cfg, "learned", n, e, q) == \
        (n + q) + counts.head(e, k)[0] + sum(counts.head(q, k)) \
        + 2 * (10 * n + 100 * q)


def test_the_four_cells_read_nothing_of_the_program():
    """No per-layer metric of the four cells has a program source: their
    traced stretch runs with the program's tracing off, as before."""
    for name in CELLS:
        assert not harness.Cell(name).reads_program(), name


def test_a_program_span_metric_turns_the_program_tracing_on():
    bench = harness.manifest()
    bench["per_layer"] = bench["per_layer"] + [dict(
        name="backbone_ms.train", unit="ms", better="lower",
        source="program_span", layer="models", moves="train_edges_per_s",
        workloads=["gcn_reddit.train_learned"])]
    assert harness.Cell("gcn_reddit.train_learned",
                        bench=bench).reads_program()
    assert not harness.Cell("gcn_reddit.train_random",
                            bench=bench).reads_program()


# ------------------------------------------------------- the trace

def _event(name, start, end, device):
    from torch.autograd import DeviceType
    rng = SimpleNamespace(start=start, end=end,
                          elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, time_range=rng,
                           device_type=DeviceType.CUDA if device
                           else DeviceType.CPU)


def _fake_profiled(monkeypatch, events):
    class Prof:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events
    monkeypatch.setattr(torch.profiler, "profile", Prof)
    return SimpleNamespace(
        cuda=SimpleNamespace(synchronize=lambda: None),
        profiler=SimpleNamespace(
            record_function=lambda name: contextlib.nullcontext()))


def test_the_program_annotations_and_stamps_are_no_device_work(
        monkeypatch):
    """A synthetic stretch (microseconds): kernels with idle gaps 0-50,
    200-260, 400-1000; the program's spans on the host and as device
    annotations, and two stamp kernels, one of them in a gap. Neither
    reaches the kernels or the busy union; each gap is labelled by the
    harness's span and, apart, by the program's (the last by none of
    them: outside)."""
    from sgs_gnn_tpu_torch.core import spans
    host = [("bench.window", 0, 1000), ("bench.train_epoch", 10, 600),
            ("bench.eval", 600, 990), ("sgs.step", 20, 300),
            ("sgs.step.replay", 10, 60), ("sgs.eval", 610, 650)]
    device = [("k1", 50, 200), ("k2", 260, 400),
              ("void stamp_kernel(long*, long*, int)", 220, 222),
              ("void stamp_kernel(long*, long*, int)", 399, 401),
              ("sgs.step.replay", 50, 400), ("bench.train_epoch", 50, 400)]
    events = [_event(n, a, b, False) for n, a, b in host]
    events += [_event(n, a, b, True) for n, a, b in device]
    fake = _fake_profiled(monkeypatch, events)
    tr = trace.traced(fake, lambda: None)
    assert set(tr.kernels) == {"k1", "k2"}
    assert tr.busy_s == pytest.approx(290e-6)
    assert tr.gaps == pytest.approx({"train_epoch": 110e-6, "eval": 600e-6})
    assert tr.program_gaps == pytest.approx({"step.replay": 50e-6,
                                             "step": 60e-6,
                                             "outside": 600e-6})
    assert sum(tr.gaps.values()) == pytest.approx(
        sum(tr.program_gaps.values()))
    # the benchmark's own labelling gives the program's label_gaps
    busy = trace._union((a, b) for n, a, b in device if n[0] == "k")
    prog = [(n[len(spans.PREFIX):], a, b) for n, a, b in host
            if n.startswith(spans.PREFIX)]
    assert tr.program_gaps == pytest.approx(
        spans.label_gaps(busy, prog, 0, 1000))
    assert set(tr.program) == {"spans", "records", "counters", "segments"}


def test_a_traced_stretch_hands_the_program_record_to_readers(monkeypatch):
    """A ``--trace 1`` rehearsal on the CPU with the program's tracing on
    from before the set-up, as ``benchmark/run.py`` turns it on: a reader
    finds the program's step spans of the traced epochs in
    ``ctx["program"]`` and its gaps on the trace."""
    from sgs_gnn_tpu_torch.core import spans
    from benchmark.tests.cpu import cpu_graphs
    seen = {}

    def read(ctx):
        seen.update(ctx)
        return 1.0
    entry = dict(name="step_calls", unit="calls", better="lower",
                 source="program_span", layer="graphed epoch",
                 moves="train_edges_per_s")
    cell = _cell("gcn_reddit.train_learned")
    cell.traffic = dict(cell.traffic, trace_epochs=1)
    monkeypatch.setattr(cell, "readers",
                        lambda: [(entry, SimpleNamespace(read=read))])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    spans.reset()
    spans.enable(device_stamps=True)
    try:
        with cpu_graphs():
            run = harness.Run(cell, 2 ** 31 + 29, "cpu")
            run.setup()
            out = run.traced()
    finally:
        spans.disable()
        spans.reset()
    assert out == {"step_calls": {"value": 1.0, "unit": "calls"}}
    prog = seen["program"]
    assert prog is run.trace.program
    trained = sum(1 for a in run.plan if a)
    assert prog["spans"]["step"]["calls"] == trained
    assert prog["counters"]["graph.replays"] > 0
    assert run.trace.program_gaps

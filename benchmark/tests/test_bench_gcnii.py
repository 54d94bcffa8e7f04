"""The GCNII configuration (``configs/sgs_gcnii_reddit.json``) and its
serving cell on the CPU at a small size:

  * in float32 the program follows the reference
    (``archs/backbone_GCNII.py``, ``archs/scorer_GCN.py``): batches exact,
    the logits under 1e-4, also where a request takes the whole graph;
  * the bfloat16 run is ``correct`` under the cell's limits, the float8
    control and each planted fault the cell catches are not;
  * the frozen counts at the cell's per-part shapes (operations, the
    bytes of a propagation) are pinned to values worked out from the
    layers;
  * the reference's constants are the port's defaults and the
    configuration's stated architecture;
  * each of the eight readers reads a synthetic ``ctx``; the four that
    load an accepted reader by path read as it does.

The CPU runs build GCNII 9 layers deep but 64 wide (the port's
``BACKBONES`` entry and the reference's ``WIDTH`` patched alike): the
published 2048 columns cost the CPU ~0.25 TFLOP a request.
"""
import functools
import importlib.util
import inspect
import json

import pytest
import torch

from benchmark import archs, compare, counts, faults, harness, reference
from benchmark.tests.cpu import small_run
from benchmark.tests.test_bench_manifest import BENCH, ROOT
from benchmark.trace import Trace

CELL = "gcnii_reddit.serve_predict"
CAUGHT = ("half_draws", "answer_altered", "node_dropped")
SMALL_WIDTH = 64


def _cfg():
    return harness.Cell(CELL).ref_cfg()


def _bb():
    return archs.backbone(_cfg())


@pytest.fixture
def narrow(monkeypatch):
    """GCNII at SMALL_WIDTH columns in the port and the reference."""
    from sgs_gnn_tpu_torch.models import backbones
    monkeypatch.setitem(backbones.BACKBONES, "GCNII", functools.partial(
        backbones.GCNIIModel, width=SMALL_WIDTH))
    monkeypatch.setattr(_bb(), "WIDTH", SMALL_WIDTH)


def _verdict(numbers):
    return compare.verdict(numbers, harness.Cell(CELL).limits)[0]


@pytest.mark.parametrize("sample_perc", [0.2, 0.6])
def test_the_reference_follows_the_program_in_float32(narrow, sample_perc):
    """At sample_perc 0.6 q exceeds a partition's valid edges: a
    whole-graph request is checked."""
    torch.manual_seed(0)
    run, _, numbers = small_run(CELL, 2 ** 31 + 17, flags=dict(
        dtype="float32", sample_perc=sample_perc))
    assert numbers["batch_mismatch"] == 0
    assert numbers["logit_gap"] < 1e-4, numbers
    assert run.weights["GCNII_conv9.lin.weight"].shape == (SMALL_WIDTH,
                                                           SMALL_WIDTH)


def test_a_bfloat16_run_is_correct_and_the_control_is_not(narrow):
    torch.manual_seed(0)
    run, _, numbers = small_run(CELL, 2 ** 31 + 5)
    assert _verdict(numbers), numbers
    control = run.check(reference.FP8, control=True)
    assert not _verdict(control), control


@pytest.mark.parametrize("fault", CAUGHT)
def test_a_planted_fault_is_not_correct(narrow, fault):
    torch.manual_seed(0)
    with faults.FAULTS[fault]():
        _, _, numbers = small_run(CELL, 2 ** 31 + 7)
    assert not _verdict(numbers), (fault, numbers)


# ------------------------------------------------------------ the counts

N, EV, EW, Q = 1870, 700_001, 150_001, 200_000   # nodes; a sampled and a
# small partition's edges; q
W = 2048


def test_the_backbone_count_is_pinned():
    # the input projection (weight gradient only); per layer the
    # propagation (2 e W, its transpose in the backward), the two blends
    # (2 n W each, both ways) and W_l (2 n W^2; the backward forms the
    # weight's and the input's gradient); the output projection
    fwd = (2 * N * 602 * W + 9 * (2 * Q * W + 4 * N * W + 2 * N * W * W)
           + 2 * N * W * 41)
    bwd = (2 * N * 602 * W + 9 * (2 * Q * W + 4 * N * W + 4 * N * W * W)
           + 4 * N * W * 41)
    assert _bb().count(_cfg(), N, Q) == (fwd, bwd) \
        == (153616015360, 295110328320)


def test_the_request_operations_are_pinned():
    cfg = _cfg()
    scorer = archs.scorer(cfg).count(cfg, N, EV)[0]
    head = counts.head(EV, 256)[0]
    assert counts.eval_flops(cfg, "learned", N, EV, Q, 11) == \
        11 * 153616015360 + scorer + head == 1875173916160
    assert counts.eval_flops(cfg, "learned", N, EV, Q, 1) == \
        153616015360 + scorer + head


def test_the_propagation_bytes_are_pinned():
    bb = _bb()
    # two int32 ids and an f32 weight an edge; n x f bf16 rows read and
    # written once
    assert bb.prop_bytes(N, Q, W) == Q * 12 + 2 * N * W * 2 == 17719040
    assert bb.prop_bytes(N, EV, 256) == EV * 12 + 2 * N * 256 * 2 \
        == 10314892


def test_the_constants_are_the_ports_defaults_and_the_configurations():
    from sgs_gnn_tpu_torch.models.backbones import GCNIIModel
    bb = _bb()
    sig = inspect.signature(GCNIIModel.__init__).parameters
    ours = dict(layers=bb.LAYERS, width=bb.WIDTH, alpha=bb.ALPHA,
                lam=bb.LAM)
    assert {k: sig[k].default for k in ours} == ours \
        == dict(layers=9, width=2048, alpha=0.5, lam=1.0)
    arch = harness.Cell(CELL).config["architecture"]
    assert (arch["layers"], arch["width"], arch["alpha"], arch["lambda"]) \
        == (bb.LAYERS, bb.WIDTH, bb.ALPHA, bb.LAM)
    assert [round(bb.beta(k), 6) for k in (1, 9)] == [0.693147, 0.105361]


def test_the_configuration_is_the_gcn_ones_with_gcnii():
    gcn = harness.Cell("gcn_reddit.serve_predict").config
    gcnii = harness.Cell(CELL).config
    assert gcnii["flags"] == dict(gcn["flags"], GNN="GCNII")
    assert gcnii["graph"] == gcn["graph"]
    assert gcnii["reduced"] == gcn["reduced"] == ["num_nodes", "communities",
                                                  "num_parts"]
    assert gcnii["source_values"] == gcn["source_values"]
    assert len(gcnii["source"]) <= 200


def test_the_port_builds_the_published_model():
    from sgs_gnn_tpu_torch.models.backbones import GCNIIModel
    cfg = _cfg()
    with torch.device("meta"):
        model = GCNIIModel(602, cfg["nhid"], 41, edge_mlp_type="GCN")
    n = sum(p.numel() for k, p in model.named_parameters() if "GCNII" in k)
    assert n == harness.Cell(CELL).config["architecture"]["parameters"] \
        == 602 * W + W + 9 * W * W + W * 41 + 41


# ----------------------------------------------------------- the readers

def _reader(name):
    return dict((m["name"], mod) for m, mod in
                harness.Cell(CELL).readers())[name]


FACTS = dict(requests=3, seconds=2.0, parts=[0, 1, 0])


def _ctx(program=None, kernels=None):
    logs = []
    kernels = kernels if kernels is not None else {
        "void spmm_tile_kernel<256>(unsigned int const*)": [30, 0.003],
        "spmm_bin_count_kernel": [30, 0.0005],
        "spmm_bin_scatter_kernel": [30, 0.0005],
        "scatter_slab_kernel": [1, 0.001],
        "segment_sum_kernel": [5, 1.0],
        "head_mma_kernel": [3, 0.5]}
    ctx = dict(trace=Trace(kernels, 0.9, 2.0, {}, program),
               facts=FACTS, cell=harness.Cell(CELL), stages={},
               shapes=dict(n=[N, 1500], e=[EV, EW], q=Q, plan=[2, 1],
                           draws=harness.Cell(CELL).traffic[
                               "num_samples_eval"]),
               program=program, log=logs.append)
    return ctx, logs


def test_every_new_reader_is_listed_for_the_one_cell():
    names = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
             if "gcnii" in m["name"]}
    assert sorted(names) == ["aggregate_ms.gcnii.serve",
                             "head_roofline.gcnii.serve",
                             "idle_share.gcnii.serve",
                             "message_gib.gcnii.serve", "mfu.gcnii.serve",
                             "rows_roofline.gcnii.serve",
                             "setup_capture_s.gcnii", "setup_data_s.gcnii"]
    for name, cells in names.items():
        assert cells == [CELL]
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["serve_p95_ms"]["workloads"][-1] == CELL
    assert harness.Cell(CELL).reads_program()


def _accepted(name):
    spec = importlib.util.spec_from_file_location(
        "base", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,base", [
    ("mfu.gcnii.serve", "mfu.serve"),
    ("idle_share.gcnii.serve", "idle_share.serve"),
    ("head_roofline.gcnii.serve", "head_roofline.serve"),
    ("setup_data_s.gcnii", "setup_data_s"),
    ("setup_capture_s.gcnii", "setup_capture_s")])
def test_a_reader_by_path_reads_as_the_accepted_one(name, base):
    ctx, _ = _ctx()
    ctx["stages"] = dict(data=4.25, capture=1.5)
    assert _reader(name).read(ctx) == _accepted(base).read(ctx) > 0
    # the accepted entry lists the GCN serving cell; this one the GCNII
    # cell, with every other field alike
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert dict(entries[name], workloads=None) \
        == dict(entries[base], name=name, workloads=None)


def test_the_readers_by_path_read_the_synthetic_trace():
    ctx, _ = _ctx()
    ctx["stages"] = dict(data=4.25, capture=1.5)
    assert _reader("idle_share.gcnii.serve").read(ctx) == \
        pytest.approx(100 * (1 - 0.9 / 2.0))
    # K3 over every valid edge of the three requests' parts, 0.5 s
    ops = sum(counts.head_eval_flops(_cfg(), e) for e in (EV, EW, EV))
    assert _reader("head_roofline.gcnii.serve").read(ctx) == \
        pytest.approx(100 * ops / counts.PEAK_BF16_FLOPS / 0.5)
    assert _reader("setup_data_s.gcnii").read(ctx) == 4.25
    assert _reader("setup_capture_s.gcnii").read(ctx) == 1.5
    ctx, logs = _ctx(kernels={"segment_sum_kernel": [1, 1.0]})
    assert _reader("head_roofline.gcnii.serve").read(ctx) is None and logs


def test_the_mfu_reader_reads_as_the_accepted_one():
    ctx, _ = _ctx()
    cfg = _cfg()
    ops = 2 * counts.eval_flops(cfg, "learned", N, EV, Q, 11) \
        + counts.eval_flops(cfg, "learned", 1500, EW, Q, 11)
    assert _reader("mfu.gcnii.serve").read(ctx) == pytest.approx(
        100 * ops / (2.0 * counts.PEAK_BF16_FLOPS))


def _prop(n, e, f):
    return e * 12 + 2 * n * f * 2


def test_the_rows_roofline_reader():
    # the K8 and K1 kernels: 0.005 s; K2's and the head's are not theirs.
    # Part 0 (twice) is sampled: the scorer's two propagations over its
    # edges and 11 x 9 GCNII ones over q; part 1 takes the whole graph
    ctx, _ = _ctx()
    b = 2 * (2 * _prop(N, EV, 256) + 99 * _prop(N, Q, W)) \
        + 9 * _prop(1500, EW, W)
    assert _reader("rows_roofline.gcnii.serve").read(ctx) == \
        pytest.approx(100 * b / counts.PEAK_HBM_BPS / 0.005)
    ctx, logs = _ctx(kernels={"segment_sum_kernel": [1, 1.0]})
    assert _reader("rows_roofline.gcnii.serve").read(ctx) is None and logs


def test_the_program_readers():
    program = dict(spans={}, records=[], counters={
        "kernels.bytes.spmm.gather_k1": 3 * 2 ** 30,
        "kernels.routes.spmm.gather_k1": 66,
        "kernels.routes.spmm.k8_tiles": 240},
        segments={"serve.aggregate": {"stamps": 297, "s": 0.027},
                  "serve.backbone": {"stamps": 330, "s": 1.0}})
    ctx, _ = _ctx(program)
    assert _reader("aggregate_ms.gcnii.serve").read(ctx) == \
        pytest.approx(9.0)
    assert _reader("message_gib.gcnii.serve").read(ctx) == 1.0
    # every aggregation on K8: no message matrix, a reading of 0
    k8 = dict(program, counters={"kernels.routes.spmm.k8_tiles": 240})
    ctx, _ = _ctx(k8)
    assert _reader("message_gib.gcnii.serve").read(ctx) == 0.0
    # a program without the stamps or the counters: nothing, no raise
    bare = dict(spans={}, records=[], counters={}, segments={})
    for name in ("aggregate_ms.gcnii.serve", "message_gib.gcnii.serve"):
        ctx, logs = _ctx(bare)
        assert _reader(name).read(ctx) is None and logs, name
        ctx, logs = _ctx(None)
        assert _reader(name).read(ctx) is None and logs, name


def test_the_limits_file_names_the_serving_checks():
    lim = json.loads((ROOT / "benchmark" / "limits"
                      / f"{CELL}.json").read_text())
    assert set(lim) == {"batch_mismatch", "logit_gap"}
    assert lim["batch_mismatch"] == 0

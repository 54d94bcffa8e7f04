"""The GIN + MLP configuration (``configs/sgs_gin_mlp_reddit.json``) and its
two cells on the CPU at a small size:

  * in float32 the program follows the reference (``archs/backbone_GIN.py``,
    ``archs/scorer_MLP.py``): batches and winners exact, every other
    number under 1e-4, also where a small step is among the checked ones;
  * the bfloat16 run is ``correct`` under the cells' limits, the float8
    control and each planted fault the cells catch are not;
  * the frozen counts at the cells' per-part shapes (operations, K1 bytes,
    message bytes) are pinned to values worked out from the layers;
  * each of the eight readers reads a synthetic ``ctx``.
"""
import importlib.util

import pytest
import torch

from benchmark import archs, compare, counts, faults, harness, reference
from benchmark.tests.cpu import small_run
from benchmark.tests.test_bench_manifest import BENCH, ROOT
from benchmark.trace import Trace

SERVE = "gin_mlp_reddit.serve_predict"
TRAIN = "gin_mlp_reddit.train_learned"
# the faults the cells' compared numbers catch on the card (PERF.md gives
# the readings and those they do not catch)
CAUGHT = {SERVE: ("half_draws", "node_dropped"),
          TRAIN: ("state_unchanged", "half_batch", "winners_altered",
                  "eval_skipped", "node_dropped")}


def _verdict(cell, numbers):
    return compare.verdict(numbers, harness.Cell(cell).limits)[0]


@pytest.mark.parametrize("cell,sample_perc", [
    (TRAIN, 0.2), (TRAIN, 0.6), (SERVE, 0.2), (SERVE, 0.6)])
def test_the_reference_follows_the_program_in_float32(cell, sample_perc):
    """At sample_perc 0.6 q exceeds a partition's valid edges: a small
    step (training) or a whole-graph request (serving) is checked."""
    torch.manual_seed(0)
    _, _, numbers = small_run(cell, 2 ** 31 + 17, flags=dict(
        dtype="float32", sample_perc=sample_perc))
    assert numbers.pop("batch_mismatch") == 0
    assert numbers.pop("winner_miss", 0.0) == 0
    assert numbers.pop("gate_gap", 0.0) == 0
    for k, v in numbers.items():
        assert v < 1e-4, (k, v)


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_a_bfloat16_run_is_correct_and_the_control_is_not(cell):
    torch.manual_seed(0)
    run, _, numbers = small_run(cell, 2 ** 31 + 5)
    assert _verdict(cell, numbers), numbers
    control = run.check(reference.FP8, control=True)
    assert not _verdict(cell, control), control


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in (TRAIN, SERVE) for f in CAUGHT[c]])
def test_a_planted_fault_is_not_correct(cell, fault):
    torch.manual_seed(0)
    with faults.FAULTS[fault]():
        _, _, numbers = small_run(cell, 2 ** 31 + 7)
    assert not _verdict(cell, numbers), (fault, numbers)


# ------------------------------------------------------------ the counts

N, EV, EW, Q = 1870, 700_001, 150_001, 200_000   # nodes; a sampled and a
# small partition's edges; q


def _cfg():
    return harness.Cell(TRAIN).ref_cfg()


def test_the_backbone_and_scorer_counts():
    cfg, bb = _cfg(), archs.backbone(_cfg())
    # per layer: the sum (an add a value, forward; backward only where the
    # input takes a gradient) and two projections of 2 n fin fout each,
    # doubled in the backward where the input's gradient is formed
    fwd = (Q * 602 + 2 * N * 602 * 256 + 2 * N * 256 * 256
           + Q * 256 + 2 * N * 256 * 256 + 2 * N * 256 * 41)
    bwd = (2 * N * 602 * 256 + 4 * N * 256 * 256
           + Q * 256 + 4 * N * 256 * 256 + 4 * N * 256 * 41)
    assert bb.count(cfg, N, Q) == (fwd, bwd) == (1277443200, 1686507520)
    assert archs.scorer(cfg).count(cfg, N, EV) == (576378880, 576378880)


def test_the_operation_counts_are_pinned():
    cfg = _cfg()
    assert counts.train_step_flops(cfg, "learned", N, EV, Q) == 348533721856
    assert counts.eval_flops(cfg, "learned", N, EV, Q, 1) == 185713284736
    assert counts.eval_flops(cfg, "learned", N, EV, Q, 11) == 198487716736


def test_the_k1_bytes_are_pinned():
    cfg, bb = _cfg(), archs.backbone(_cfg())

    def k1(e, f):
        return e * f * 4 + e * 4 + N * f * 4
    fwd = k1(Q, 602) + k1(Q, 256)
    assert bb.k1_step_bytes(cfg, N, EV, Q, 2) == \
        2 * (fwd + k1(Q, 256)) + 2 * k1(Q, 41) == 1871678800
    assert bb.k1_step_bytes(cfg, N, EW, Q, 1) == \
        k1(EW, 602) + 2 * k1(EW, 256) == 678537188
    assert bb.k1_eval_bytes(cfg, N, EV, Q, 11, False) == 11 * fwd \
        == 7638596240
    assert bb.k1_eval_bytes(cfg, N, EW, Q, 11, True) == \
        k1(EW, 602) + k1(EW, 256) == 522421280


def test_the_message_bytes_are_pinned():
    cfg, bb = _cfg(), archs.backbone(_cfg())
    per = Q * (602 + 256) * 4
    assert bb.message_step_bytes(cfg, EV, Q, 2) == 2 * per == 1372800000
    assert bb.message_step_bytes(cfg, EW, Q, 1) == EW * 858 * 4
    assert bb.message_eval_bytes(cfg, EV, Q, 11, False) == 11 * per \
        == 7550400000
    assert bb.message_eval_bytes(cfg, EW, Q, 11, True) == 514803432


# ----------------------------------------------------------- the readers

def _reader(name):
    return dict((m["name"], mod) for m, mod in
                harness.Cell(SERVE if name.endswith("serve")
                             else TRAIN).readers())[name]


def _ctx(cell, facts, program=None):
    logs = []
    kernels = {"void scatter_slab_kernel<4>(float const*)": [10, 0.004],
               "scatter_direct_kernel": [1, 0.001],
               "segment_sum_kernel": [5, 1.0],
               "head_mma_kernel": [3, 0.5]}
    ctx = dict(trace=Trace(kernels, 0.9, 2.0, {}, program),
               facts=facts, cell=harness.Cell(cell), stages={},
               shapes=dict(n=[N, 1500], e=[EV, EW], q=Q, plan=[2, 1],
                           draws=harness.Cell(cell).traffic[
                               "num_samples_eval"]),
               program=program, log=logs.append)
    return ctx, logs


def test_every_new_reader_is_listed_for_its_one_cell():
    names = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
             if "gin_mlp" in m["name"]}
    assert len(names) == 8
    for name, cells in names.items():
        assert cells == [SERVE if name.endswith("serve") else TRAIN]
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()


def test_the_mfu_readers_read_as_the_accepted_ones():
    serve = dict(requests=3, seconds=2.0, parts=[0, 1, 0])
    train = dict(epochs=2, steps=4, evals=4, seconds=2.0, eval_s=0.5)
    for name, facts in (("mfu.gin_mlp.serve", serve),
                        ("mfu.gin_mlp.train", train)):
        cell = SERVE if name.endswith("serve") else TRAIN
        ctx, _ = _ctx(cell, facts)
        base = name.replace(".gin_mlp", "")
        spec = importlib.util.spec_from_file_location(
            "base", ROOT / "benchmark" / "metrics" / f"{base}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert _reader(name).read(ctx) == mod.read(ctx) > 0
    cfg = _cfg()
    ctx, _ = _ctx(SERVE, serve)
    ops = 2 * counts.eval_flops(cfg, "learned", N, EV, Q, 11) \
        + counts.eval_flops(cfg, "learned", 1500, EW, Q, 11)
    assert _reader("mfu.gin_mlp.serve").read(ctx) == pytest.approx(
        100 * ops / (2.0 * counts.PEAK_BF16_FLOPS))


def _k1(n, e, f):
    return e * f * 4 + e * 4 + n * f * 4


def test_the_rows_roofline_readers():
    # K1's device time: the slab and direct kernels, 0.005 s; K2's and the
    # head's are not K1's
    ctx, _ = _ctx(SERVE, dict(requests=3, seconds=2.0, parts=[0, 1, 0]))
    b = 2 * 11 * (_k1(N, Q, 602) + _k1(N, Q, 256)) \
        + _k1(1500, EW, 602) + _k1(1500, EW, 256)
    assert _reader("rows_roofline.gin_mlp.serve").read(ctx) == \
        pytest.approx(100 * b / counts.PEAK_HBM_BPS / 0.005)
    ctx, _ = _ctx(TRAIN, dict(epochs=2, steps=4, evals=4, seconds=2.0,
                              eval_s=0.5))
    step = 2 * (_k1(N, Q, 602) + 2 * _k1(N, Q, 256)) + 2 * _k1(N, Q, 41)
    small = _k1(1500, EW, 602) + 2 * _k1(1500, EW, 256)
    evals = _k1(N, Q, 602) + _k1(N, Q, 256) + _k1(1500, EW, 602) \
        + _k1(1500, EW, 256)
    assert _reader("rows_roofline.gin_mlp.train").read(ctx) == \
        pytest.approx(100 * 2 * (step + small + evals)
                      / counts.PEAK_HBM_BPS / 0.005)
    ctx["trace"] = Trace({"segment_sum_kernel": [1, 1.0]}, 1.0, 2.0, {})
    assert _reader("rows_roofline.gin_mlp.train").read(ctx) is None


def test_the_program_readers():
    program = dict(spans={}, records=[], counters={
        "kernels.bytes.spmm.gather_k1": 3 * 2 ** 30,
        "kernels.routes.spmm.gather_k1": 66},
        segments={"serve.aggregate": {"stamps": 66, "s": 0.027},
                  "step.aggregate": {"stamps": 16, "s": 0.008},
                  "eval.aggregate": {"stamps": 8, "s": 1.0}})
    serve = dict(requests=3, seconds=2.0, parts=[0, 1, 0])
    train = dict(epochs=2, steps=4, evals=4, seconds=2.0, eval_s=0.5)
    ctx, _ = _ctx(SERVE, serve, program)
    assert _reader("aggregate_ms.gin_mlp.serve").read(ctx) == \
        pytest.approx(9.0)
    assert _reader("message_gib.gin_mlp.serve").read(ctx) == 1.0
    ctx, _ = _ctx(TRAIN, train, program)
    assert _reader("aggregate_ms.gin_mlp.train").read(ctx) == \
        pytest.approx(2.0)
    assert _reader("message_gib.gin_mlp.train").read(ctx) == 0.75
    # a program without the stamps or the counter: nothing, no raise
    bare = dict(spans={}, records=[], counters={}, segments={})
    for name, cell, facts in (
            ("aggregate_ms.gin_mlp.serve", SERVE, serve),
            ("message_gib.gin_mlp.serve", SERVE, serve),
            ("aggregate_ms.gin_mlp.train", TRAIN, train),
            ("message_gib.gin_mlp.train", TRAIN, train)):
        ctx, logs = _ctx(cell, facts, bare)
        assert _reader(name).read(ctx) is None and logs, name


def test_the_new_cells_turn_the_program_tracing_on():
    assert harness.Cell(SERVE).reads_program()
    assert harness.Cell(TRAIN).reads_program()


def test_the_configuration_is_the_gat_ones_with_gin_and_mlp():
    gat = harness.Cell("gat_gsage_reddit.train_learned").config
    gin = harness.Cell(TRAIN).config
    want = dict(gat["flags"], GNN="GIN", edge_mlp_type="MLP")
    del want["gat_heads"]
    assert gin["flags"] == want
    assert gin["graph"] == gat["graph"]
    assert gin["reduced"] == gat["reduced"] == ["num_nodes", "communities",
                                                 "num_parts"]
    assert len(gin["source"]) <= 200


"""tools/reddit_scale_torch.py, the port's twin of Scripts/run_reddit_scale.sh
and Scripts/run_reddit_modes.sh, and chip_smoke.py's ``reddit_scale``
helpers, on the CPU.

The two scripts' command lines are read out of the files (line
continuations joined, their variables expanded, the mode loops unrolled)
and given to the port's CLI parser: every flag must be one the parser
knows, and the ``Config`` must equal the one chip_smoke.py's
``reddit_config`` builds for the tool's run (the port's ``--device`` is no
``Config`` field). The tool's epochs and JAX reference F1s must be the
ones its cited logs show. ``HostStages`` must leave the batches as
``prepare_batches`` builds them and restore every function it wraps.
tools/stable_argsort_ab.py's uint16 radix turn must build the same batches
as the port's plain sort and give the modules their numpy back.
"""
import importlib.util
import re
import shlex
from pathlib import Path

import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch.core import Config
from sgs_gnn_tpu_torch.core.graph import Graph
from sgs_gnn_tpu_torch.data import HostDataset, registry
from sgs_gnn_tpu_torch.data import synthetic as tsyn
from sgs_gnn_tpu_torch.data import transforms as ttr
from sgs_gnn_tpu_torch.data.priors import degree_prior
from sgs_gnn_tpu_torch.run import driver
from sgs_gnn_tpu_torch.run.cli import build_parser, config_from_args

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool():
    return _load("reddit_scale_torch", "tools/reddit_scale_torch.py")


def _smoke():
    return _load("chip_smoke", "chip_smoke.py")


def _expand(text, env):
    return re.sub(r"\$\{(\w+)(:-[^}]*)?\}", lambda m: env[m.group(1)], text)


def script_runs(name, epochs_of):
    """[(dataset, mode, argv)] of each run of Scripts/``name``: the argv
    after ``-m sgs_gnn_tpu.run.cli``, with ${EPOCHS} set by
    ``epochs_of(dataset, mode)``, ${MODE} by the loop around it (its
    default list) and the other variables by their assignments."""
    text = (ROOT / "Scripts" / name).read_text().replace("\\\n", " ")
    assigned = dict(re.findall(r'^(\w+)="([^"]*)"', text, re.M))
    runs, modes = [], [None]
    for line in text.splitlines():
        loop = re.match(r"\s*for MODE in \$\{\w+:-([^}]*)\}", line)
        if loop:
            modes = loop.group(1).split()
        if line.strip() == "done":
            modes = [None]
        if "sgs_gnn_tpu.run.cli" not in line:
            continue
        cmd = line.split("sgs_gnn_tpu.run.cli", 1)[1].split("2>&1")[0]
        for mode in modes:
            # EPOCHS depends on the dataset and mode: set it last
            env = dict(MODE=mode or "", EPOCHS="@EPOCHS@")
            env.update({k: _expand(v, env) for k, v in assigned.items()})
            argv = shlex.split(_expand(cmd, env))
            dataset = argv[argv.index("--dataset") + 1]
            mode_ = argv[argv.index("--mode") + 1]
            epochs = str(epochs_of(dataset, mode_))
            runs.append((dataset, mode_, [epochs if a == "@EPOCHS@" else a
                                          for a in argv]))
    return runs


def test_tool_builds_the_scripts_configs():
    tool, smoke = _tool(), _smoke()
    epochs = {(d, m): e for _, d, m, e, _, _ in tool.RUNS}
    seen = []
    for name in ("run_reddit_scale.sh", "run_reddit_modes.sh"):
        for dataset, mode, argv in script_runs(
                name, lambda d, m: epochs[(d, m)]):
            _, unknown = build_parser().parse_known_args(argv)
            assert unknown == [], (name, unknown)
            want = config_from_args(argv)
            want.validate()
            got = smoke.reddit_config(dataset, mode,
                                      epochs[(dataset, mode)])
            assert got == want, (name, dataset, mode)
            # the TPU-only flags are accepted and read by nothing
            assert got.prng_impl == "rbg" and got.approx_topk
            assert got.scan_epoch == "auto" and got.num_samples_eval == 1
            seen.append((name, dataset, mode))
    assert seen == [(s, d, m) for s, d, m, *_ in tool.RUNS]


@pytest.mark.parametrize("run", range(7))
def test_tool_epochs_and_f1s_are_its_logs(run):
    """Each run's epochs are its JAX log's last ``Iteration:`` and its
    reference F1 the log's final test F1 at the cited line."""
    _, _, _, epochs, f1, where = _tool().RUNS[run]
    path, line = where.split(":")
    text = (ROOT / path).read_text().splitlines()
    assert text[int(line) - 1] == \
        f"Best Test F1 after loading saved model: {f1:.4f}"
    iters = [int(m.group(1)) for ln in text
             for m in [re.match(r"Iteration:\s+(\d+)", ln)] if m]
    assert iters[-1] == epochs


def _small_dataset():
    x, ei, y, (tr, va, te) = tsyn.community_sbm_graph(
        n=1200, communities=4, deg=40, seed=3)
    ei = ttr.to_undirected(ei)
    return HostDataset(name="SyntheticReddit1200", x=x, edge_index=ei, y=y,
                       train_mask=tr, val_mask=va, test_mask=te,
                       prob=degree_prior(ei[0], ei[1], 1200),
                       num_classes=int(y.max()) + 1,
                       He=ttr.edge_homophily(ei, y))


def test_host_stages_keep_the_batches_and_restore_the_functions():
    smoke = _smoke()
    ds = _small_dataset()
    cfg = Config(mode="learned", pipeline="hybrid", tile_index="on",
                 metis_threshold=20_000, shape_classes=3)
    want, q, method = driver.prepare_batches(cfg, ds, "cpu")
    saved = (driver.prepare_batches, driver.partition_nodes,
             driver.induced_subgraphs, registry.to_undirected,
             registry.community_sbm_graph, Graph.build)
    with smoke.HostStages(torch) as st:
        got, q2, method2 = driver.prepare_batches(cfg, ds, "cpu")
    assert (driver.prepare_batches, driver.partition_nodes,
            driver.induced_subgraphs, registry.to_undirected,
            registry.community_sbm_graph, Graph.build) == saved
    assert (q2, method2) == (q, method) and st.batches is got
    assert len(got) == len(want) >= 3
    for a, b in zip(want, got):
        for f, va in vars(a).items():
            vb = getattr(b, f)
            if isinstance(va, torch.Tensor):
                assert torch.equal(va, vb), f
            else:
                assert va == vb, f
    assert set(st.seconds) == {"prepare_batches", "partition", "subgraphs",
                               "copy"}
    assert all(v >= 0 for v in st.seconds.values())
    assert st.batch_bytes == sum(
        t.numel() * t.element_size() for g in got for t in vars(g).values()
        if isinstance(t, torch.Tensor))
    plan = smoke.plan_of(got)
    assert plan["batch_nodes"] == got[0].num_nodes
    assert plan["tile_slots"] == got[0].tile_ls.shape[0]
    host = st.summary(0.0)
    assert host["subgraphs"] == pytest.approx(
        st.seconds["subgraphs"] - st.seconds["copy"])
    assert np.isfinite(list(host.values())).all()


def test_argsort_ab_radix_turn_builds_the_same_batches():
    from sgs_gnn_tpu_torch.core import graph
    from sgs_gnn_tpu_torch.data import partition
    from sgs_gnn_tpu_torch.ops import score_tiles
    ab = _load("stable_argsort_ab", "tools/stable_argsort_ab.py")
    cfg = Config(mode="learned", pipeline="hybrid", tile_index="on",
                 metis_threshold=20_000, shape_classes=3)
    lines = ab.ab(torch, cfg, _small_dataset())
    assert lines is not None
    assert [ln["variant"] for ln in lines] == ["radix", "plain", "plain",
                                               "radix"]
    assert all(ln["parts"] >= 3 and ln["part_edge_ids_s"] >= 0
               for ln in lines)
    for mod in (graph, partition, score_tiles):
        assert mod.np is np
    rng = np.random.default_rng(6)
    for lo, hi, dtype in ((0, 300, np.int32), (0, 65536, np.int64),
                          (0, 65537, np.int64), (-3, 40, np.int32),
                          (0, 2, np.int32)):
        keys = rng.integers(lo, hi, 20_000).astype(dtype)
        np.testing.assert_array_equal(ab.radix_argsort(keys, kind="stable"),
                                      np.argsort(keys, kind="stable"))

"""The port's diagnostics (``utils/profiler.py``, ``utils/debug.py``,
``viz/curves.py``), the driver's ``--gpu_profile``, ``--debug_checks`` and
``--plot_curve`` hooks and its ``[fastpath] dense_subgraph=`` line, on the
CPU: twins of ``tests/test_aux.py``'s profiler, debug, curves and
fast-path tests, and one ``run_experiment`` with all three flags.
"""
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch import Config, Graph, get_model
from sgs_gnn_tpu_torch.run import cli, driver
from sgs_gnn_tpu_torch.utils import (SegmentTimer, checked, device_memory_mb,
                                     find_nans, make_segment_profiler, timed,
                                     trace, validate_graph)
from sgs_gnn_tpu_torch.viz import plot_hist, plot_learning_curves, plot_probs


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, so parallel test workers do not wait at
    thread barriers; the port's float32 default dtype
    (tests/test_reference_oracle.py sets float64 when it is imported)."""
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def _graph(rng, n=50, e=400, f=16, c=4, **kw):
    """tests/conftest.py's ``random_graph`` as a port Graph on the CPU."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    perm = rng.permutation(n)
    masks = np.zeros((3, n), bool)
    masks[0, perm[: n // 3]] = True
    masks[1, perm[n // 3: 2 * n // 3]] = True
    masks[2, perm[2 * n // 3:]] = True
    prob = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return Graph.build(x, np.stack([s, r]), y, *masks, prob=prob / prob.sum(),
                       num_classes=c, device="cpu", **kw)


# --------------------------------------------------------------- profiler


def test_profiler_segment_timer():
    t = SegmentTimer()
    x = torch.ones(64, 64)
    dt = t.time_segment("gnn_forward", lambda a: a * 2, x, iters=2)
    assert dt > 0
    s = t.summarize()
    assert "gnn_forward" in s and s["gnn_forward"]["calls"] == 1
    lines = []
    t.report(log_fn=lines.append)
    assert "gnn_forward" in lines[0]
    assert timed(lambda a: {"y": [a @ a]}, x, iters=2) > 0
    assert device_memory_mb("cpu") is None
    assert SegmentTimer(enabled=False).time_segment("x", torch.ones,
                                                    1) is None


def test_segment_profiler_names_and_values(rng):
    g = _graph(rng)
    q = 100
    cfg = Config(mode="learned", pipeline="hybrid", conditional=True,
                 nhid=32)
    model = get_model(cfg.GNN, g.x.shape[1], cfg.nhid, g.num_classes,
                      cfg.drop_rate, cfg.edge_mlp_type, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    prof = make_segment_profiler(cfg, model, q)
    ms, mb = prof(g, torch.Generator().manual_seed(1))
    assert set(ms) == set(mb) == set(SegmentTimer.SEGMENTS)
    assert all(v > 0 and np.isfinite(v) for v in ms.values())
    # the CPU has no allocator statistics: every segment reports 0 MiB
    assert all(v == 0.0 for v in mb.values())
    # profiling updates nothing
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)
    # a baseline mode runs no scorer: its segments report zero
    ms2, mb2 = make_segment_profiler(Config(mode="random"), model, q)(
        g, torch.Generator().manual_seed(2))
    assert ms2["edge_mlp_pre"] == 0.0 and ms2["edge_score"] == 0.0
    assert mb2["edge_mlp_pre"] == 0.0
    assert ms2["backward"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0


# ------------------------------------------------------------------ debug


def test_debug_validate_graph_and_checked(rng):
    g = _graph(rng, n=20)
    validate_graph(g)                                  # healthy graph passes
    bad = replace(g, senders=torch.full_like(g.senders, 99))
    with pytest.raises(ValueError, match="out of range"):
        validate_graph(bad)
    masks = replace(g, val_mask=g.train_mask)
    with pytest.raises(ValueError, match="overlap"):
        validate_graph(masks)
    labels = replace(g, y=g.y + 10)
    with pytest.raises(ValueError, match="labels out of range"):
        validate_graph(labels)

    f = checked(torch.log)
    np.testing.assert_allclose(f(torch.ones(4)).numpy(), 0.0)
    with pytest.raises(FloatingPointError):
        f(torch.zeros(4) - 1.0)              # log of a negative: NaN
    with pytest.raises(FloatingPointError, match="b"):
        checked(lambda: {"a": torch.ones(2), "b": torch.zeros(2) / 0})()

    assert find_nans({"a": torch.ones(3), "b": torch.tensor([np.nan])}) \
        == ["b"]
    assert find_nans([torch.ones(2), (torch.tensor([np.inf]),)]) == ["1/0"]
    assert find_nans({"i": torch.tensor([1, 2])}) == []


def test_validate_graph_flags_padding_prior(rng):
    g = _graph(rng, n=30, e=200, pad_edges_to=260)
    validate_graph(g)
    prob = g.prob.clone()
    prob[~g.edge_mask] = 0.01
    with pytest.raises(ValueError, match="padding edges carry prior"):
        validate_graph(replace(g, prob=prob))
    neg = g.prob.clone()
    neg[0] = -1.0
    with pytest.raises(ValueError, match="prior has negative"):
        validate_graph(replace(g, prob=neg))


def test_validate_graph_flags_stale_receiver_band(rng):
    n, e = 30, 300
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    g = Graph.build(x, np.stack([s, r]), y, sort_by_receiver=True,
                    device="cpu")
    validate_graph(g)                               # the band it was built with
    assert g.receiver_band > 8
    bad = replace(g, receiver_band=8)
    with pytest.raises(ValueError, match="band"):
        validate_graph(bad)
    # unsorted receivers with a declared band must fail
    g2 = Graph.build(x, np.stack([s, r]), y, device="cpu")
    g2 = replace(g2, receiver_band=64)
    with pytest.raises(ValueError, match="sorted"):
        validate_graph(g2)


# ------------------------------------------------------------------- viz


def test_viz_curves(tmp_path, rng):
    p1 = plot_learning_curves(0, [0.1, 0.5], [0.1, 0.4], [0.1, 0.3],
                              path=str(tmp_path / "curves.png"))
    probs = rng.uniform(0, 1, 200)
    p2 = plot_probs(probs, probs / probs.sum(), path=str(tmp_path / "p.png"))
    p3 = plot_hist(probs, probs, probs[:10], probs[:10],
                   path=str(tmp_path / "h.png"))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 0
    fig = plot_learning_curves(1, [0.2], [0.2], [0.2])
    assert fig.axes[0].get_title() == "run 1"


# ---------------------------------------------------------------- driver


def test_fastpath_dense_subgraph_line(rng):
    g = _graph(rng)
    q = 240

    def dense_line(device="cpu", **kw):
        lines = []
        driver.log_fastpath_status(Config(mode="learned", pipeline="hybrid",
                                          **kw), [g], q, device,
                                   lines.append)
        assert lines[0].startswith("[fastpath] tile_score_kernel=")
        assert lines[1].startswith("[fastpath] dense_subgraph=")
        assert all("(" in ln for ln in lines)
        return lines[1]

    # the JAX line's words (tests/test_aux.py): auto declines off a TPU
    assert "dense_subgraph=off (dense_subgraph=auto on device=cpu" in \
        dense_line()
    assert driver.dense_status(Config(), 2048, 200_000, "cuda").startswith(
        "off (dense_subgraph=auto on device=cuda")
    assert "dense_subgraph=on (N=50" in dense_line(dense_subgraph="on")
    assert "(--dense_subgraph off)" in dense_line(dense_subgraph="off")
    assert "> dense_threshold=40" in dense_line(dense_subgraph="on",
                                                dense_threshold=40)
    assert "needs conditional or sparse_edge_mlp" in dense_line(
        dense_subgraph="on", conditional=False)
    assert driver.dense_status(Config(mode="full", dense_subgraph="on"),
                               50, q, "cpu") == "off (learned mode only)"


def test_experiment_with_the_diagnostics_flags(tmp_path):
    base = dict(dataset="SyntheticSBM", metis_threshold=20000,
                shape_classes=2, nhid=16, runs=1, num_samples_eval=3,
                mode="learned", pipeline="hybrid", conditional=True,
                sparse_edge_mlp=True, epochs=3, convergence=0.0,
                save_csv=False, results_dir=str(tmp_path), stats=True)
    flags = dict(gpu_profile=True, debug_checks=True, plot_curve=True)
    # the multi-rank routes (one rank here) print the JAX drivers' keys:
    # halo profiles the whole graph's segments
    for route, keys in ((dict(halo=True), ["halo_step_time_ms"]),
                        (dict(data_parallel="on"),
                         ["super_step_time_ms", "super_steps"])):
        route_lines = []
        driver.run_experiment(Config(**dict(base, epochs=1), **flags,
                                     **route),
                              log_fn=route_lines.append, device="cpu")
        (ln,) = [ln for ln in route_lines if ln.startswith("[gpu-profile]")]
        fields = dict(kv.split("=") for kv in ln.split()[1:])
        assert [k for k in fields if not k.endswith(("_ms", "_mb"))] == \
            ["epoch"] + keys[1:] + ["mem"], ln
        assert fields["epoch"] == "0" and float(fields[keys[0]]) > 0.0
    lines = []
    (res,) = driver.run_experiment(Config(**base, **flags),
                                   log_fn=lines.append, device="cpu")
    prof = [ln for ln in lines if ln.startswith("[gpu-profile]")]
    assert len(prof) == 3
    for epoch, ln in enumerate(prof):
        fields = dict(kv.split("=") for kv in ln.split()[1:])
        assert fields["epoch"] == str(epoch)
        assert fields["mem"] == "n/a"
        for seg in SegmentTimer.SEGMENTS:
            assert float(fields[f"{seg}_ms"]) > 0.0
            assert float(fields[f"{seg}_mb"]) == 0.0
    png = tmp_path / "curves_SyntheticSBM_learned_run0.png"
    assert os.path.getsize(png) > 0
    # the diagnostics change nothing the run computes
    (plain,) = driver.run_experiment(Config(**base), log_fn=lambda *a: None,
                                     device="cpu")
    assert res.losses == plain.losses
    assert res.test_curve == plain.test_curve


def test_cli_parses_the_diagnostics_flags():
    cfg = cli.config_from_args(["--gpu_profile", "True", "--debug_checks",
                                "--plot_curve", "true", "--dense_subgraph",
                                "on"])
    assert cfg.gpu_profile and cfg.debug_checks and cfg.plot_curve
    assert cfg.dense_subgraph == "on"
    # as in the JAX CLI: a bare --plot_curve means False
    assert not cli.config_from_args(["--plot_curve"]).plot_curve

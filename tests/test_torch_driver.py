"""The port's experiment driver, checkpoint/resume and CLI
(``sgs_gnn_tpu_torch/run``) against the JAX package, on the CPU.

  * Full mode without dropout is deterministic, so ``run_experiment`` on
    partitioned SyntheticSBM (4 padded partitions in 2 shape classes)
    must follow the JAX driver (``scan_epoch='off'``) epoch by epoch, from
    the same initial parameters (JAX's ``init_params`` moved in by
    ``params_from_jax`` through the port driver's ``init_model`` hook):
    losses rtol 1e-4; F1s within 2 nodes of each split (2 / split size);
    iterations (early stop) and the CSV row alike.
  * A learned run takes each batch's big / small / skip decision by the
    JAX driver's host rule (valid edges > q, any train node).
  * A run stopped after 2 epochs and resumed to 4 equals a 4-epoch run:
    parameters and optimizer state bit-equal, losses and curves equal.
  * The CLI's parser has the JAX parser's options except ``--device``.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_gnn_tpu.core import Config as JConfig
from sgs_gnn_tpu.data import registry as jreg
from sgs_gnn_tpu.models import get_model as jax_get_model, init_params
from sgs_gnn_tpu.run import cli as jcli
from sgs_gnn_tpu.run import driver as jdriver

from sgs_gnn_tpu_torch import get_model, params_from_jax
from sgs_gnn_tpu_torch.core import Config
from sgs_gnn_tpu_torch.data import registry as treg
from sgs_gnn_tpu_torch.run import checkpoint, cli, driver

BASE = dict(dataset="SyntheticSBM", metis_threshold=20000, shape_classes=2,
            nhid=16, runs=1, num_samples_eval=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """A CPU run of the driver is many small ops. With one intra-op thread
    they never wait at a thread barrier, which costs them an order of
    magnitude when parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


def _jax_init(cfg, in_channels, num_classes, run, device):
    jm = jax_get_model("GCN", in_channels, cfg.nhid, num_classes,
                       cfg.drop_rate, "GCN")
    x = jnp.zeros((8, in_channels), jnp.float32)
    s = jnp.arange(8, dtype=jnp.int32)
    params = init_params(jm, jax.random.PRNGKey(cfg.seed * 1000 + run), x, s,
                         s)
    tm = get_model("GCN", in_channels, cfg.nhid, num_classes, cfg.drop_rate,
                   "GCN", device=device)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tm


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_full_mode_run_matches_jax(monkeypatch, tmp_path):
    kw = dict(BASE, mode="full", drop_rate=0.0, epochs=7, convergence=10.0,
              lr=0.01, save_csv=True)
    jcfg = JConfig(results_dir=str(tmp_path / "jax"), scan_epoch="off",
                   donate=False, **kw)
    tcfg = Config(results_dir=str(tmp_path / "torch"), log=True, **kw)
    jds = jreg.get_dataset(jcfg)
    tds = treg.get_dataset(tcfg)
    (jr,) = jdriver.run_experiment(jcfg, jds, log_fn=_quiet)
    monkeypatch.setattr(driver, "init_model", _jax_init)
    lines = []
    (tr,) = driver.run_experiment(tcfg, tds, log_fn=lines.append,
                                  device="cpu")
    assert tr.plan["parts"] == 4 and len(tr.plan["shape_classes"]) == 2
    assert tr.plan["partitioner"] == "native"
    assert any("partitioner=native" in ln for ln in lines)
    assert tr.num_iterations == jr.num_iterations == 6      # early stop
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-4)
    counts = {s: int(getattr(tds, f"{s}_mask").sum())
              for s in ("train", "val", "test")}
    for s in ("train", "val", "test"):
        tol = 2.0 / counts[s]
        np.testing.assert_allclose(getattr(tr, f"{s}_curve"),
                                   getattr(jr, f"{s}_curve"), rtol=0,
                                   atol=tol, err_msg=s)
        assert abs(getattr(tr, f"final_{s}_f1")
                   - getattr(jr, f"final_{s}_f1")) <= tol, s
    assert tr.total_updates == jr.total_updates
    (jh, jrow), (th, trow) = (_rows(tmp_path / d / "SyntheticSBM" / "0.2.csv")
                              for d in ("jax", "torch"))
    assert jh == th and trow[:4] == jrow[:4]
    np.testing.assert_allclose([float(v) for v in trow[4:]],
                               [float(v) for v in jrow[4:]], rtol=1e-4,
                               atol=2.0 / counts["train"])


def test_learned_batches_follow_the_host_rule(monkeypatch, tmp_path):
    """Big (valid edges > q), small (valid <= q: force_small) and skipped
    (no train node) batches as the JAX driver decides them."""
    jcfg0 = JConfig(mode="learned", pipeline="hybrid", **BASE)
    jds = jreg.get_dataset(jcfg0)
    jb, _ = jdriver.prepare_batches(jcfg0, jds)
    valid = sorted(int(np.asarray(g.edge_mask).sum()) for g in jb)
    # q between the partitions' sizes; the first partition loses its
    # train nodes
    perc = (valid[1] + 1) / BASE["metis_threshold"]
    from sgs_gnn_tpu.data.partition import partition_nodes
    part = partition_nodes(jds.edge_index, jds.num_nodes, 4, "native")
    train = jds.train_mask & (part != part[0])
    jds = dataclasses.replace(jds, train_mask=train)
    jcfg = jcfg0.replace(sample_perc=perc)
    jb, q = jdriver.prepare_batches(jcfg, jds)
    valid_e = [int(np.asarray(g.edge_mask).sum()) for g in jb]
    has_train = [bool(np.asarray(g.train_mask).any()) for g in jb]
    want = dict(big=sum(h and v > q for h, v in zip(has_train, valid_e)),
                small=sum(h and v <= q for h, v in zip(has_train, valid_e)),
                skipped=has_train.count(False))
    assert want["big"] and want["small"] and want["skipped"]

    calls = {True: 0, False: 0}       # by small (case 1) or sampled (2)
    make = driver.make_scan_epoch_step

    def counting(*a, **k):
        steps = make(*a, **k)

        def counted(case, small):
            def run(g, gen):
                calls[small] += 1
                return case(g, gen)
            return run
        steps.cases = {c: counted(f, c == 1) for c, f in steps.cases.items()}
        return steps
    monkeypatch.setattr(driver, "make_scan_epoch_step", counting)
    tds = dataclasses.replace(treg.get_dataset(Config(**BASE)),
                              train_mask=train)
    tcfg = Config(mode="learned", pipeline="hybrid", epochs=2,
                  sample_perc=perc, save_csv=False, **BASE)
    (res,) = driver.run_experiment(tcfg, tds, log_fn=_quiet, device="cpu")
    assert res.plan["q"] == q and res.epoch_route == "loop"
    assert {k: res.plan[k] for k in want} == want
    assert calls == {False: 2 * want["big"], True: 2 * want["small"]}
    assert res.total_updates == 2 * (want["big"] + want["small"])
    assert 0 <= res.conditional_updates <= 2 * want["big"]
    assert all(np.isfinite(res.losses))


def _capture_models(monkeypatch):
    models = []
    init = driver.init_model

    def capture(*a, **k):
        models.append(init(*a, **k))
        return models[-1]
    monkeypatch.setattr(driver, "init_model", capture)
    return models


def test_resume_reproduces_an_uninterrupted_run(monkeypatch, tmp_path):
    models = _capture_models(monkeypatch)
    kw = dict(BASE, mode="learned", pipeline="hybrid", checkpoint_every=1,
              save_csv=False, convergence=0.0)
    ds = treg.get_dataset(Config(**BASE))
    (whole,) = driver.run_experiment(
        Config(epochs=4, results_dir=str(tmp_path / "a"), **kw), ds,
        log_fn=_quiet, device="cpu")
    driver.run_experiment(Config(epochs=2, results_dir=str(tmp_path / "b"),
                                 **kw), ds, log_fn=_quiet, device="cpu")
    lines = []
    (resumed,) = driver.run_experiment(
        Config(epochs=4, resume=True, log=True,
               results_dir=str(tmp_path / "b"), **kw),
        ds, log_fn=lines.append, device="cpu")
    assert resumed.start_epoch == 2 and len(resumed.epoch_times) == 2
    assert any("resumed run 0 from epoch 2" in ln for ln in lines)
    for f in ("losses", "train_curve", "val_curve", "test_curve",
              "best_val_f1", "test_at_best_val", "best_test_f1",
              "final_train_f1", "final_val_f1", "final_test_f1"):
        assert getattr(resumed, f) == getattr(whole, f), f
    # the best-val parameters the final eval ran on
    for (n, a), b in zip(models[0].state_dict().items(),
                         models[2].state_dict().values()):
        assert torch.equal(a, b), n
    name = "SyntheticSBM_learned_hybrid_run0.pt"
    sa, sb = (checkpoint.load_checkpoint(str(tmp_path / d / "ckpt" / name))
              for d in ("a", "b"))
    assert sa.epoch == sb.epoch == 3
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
    assert set(sa.opt_state) == set(sb.opt_state) == {"gnn", "edge"}
    for grp, st in sa.opt_state.items():
        assert torch.equal(st["count"], sb.opt_state[grp]["count"])
        for a, b in zip(st["mu"] + st["nu"],
                        sb.opt_state[grp]["mu"] + sb.opt_state[grp]["nu"]):
            assert (a is None and b is None) or torch.equal(a, b)


def test_checkpoint_roundtrip_is_atomic(tmp_path):
    path = str(tmp_path / "c" / "s.pt")
    assert checkpoint.load_checkpoint(path) is None
    st = checkpoint.TrainState(
        params={"w": torch.arange(3.0)},
        opt_state={"all": {"count": torch.tensor(2, dtype=torch.int32),
                           "mu": [torch.ones(2), None],
                           "nu": [torch.zeros(2), None]}},
        epoch=5, losses=[1.0, 0.5], best_params=None)
    checkpoint.save_checkpoint(path, st)
    assert not (tmp_path / "c" / "s.pt.tmp").exists()
    back = checkpoint.load_checkpoint(path)
    assert back.epoch == 5 and back.losses == [1.0, 0.5]
    assert torch.equal(back.params["w"], st.params["w"])
    assert back.opt_state["all"]["mu"][1] is None


@pytest.mark.parametrize("flag,item", [
    (dict(data_parallel="on"), 8), (dict(halo=True), 8),
    (dict(multihost=True), 8)])
def test_unported_options_raise(flag, item):
    """The options that raised until ROADMAP §1 item 8 ported them now
    run (here as a one-rank group on the CPU): the driver refuses none of
    the JAX driver's flags. The group it started ends with the run."""
    assert item == 8 and not hasattr(driver, "check_ported")
    (res,) = driver.run_experiment(
        Config(dataset="Karate", metis_threshold=50, epochs=2,
               save_csv=False, **flag), log_fn=_quiet, device="cpu")
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert res.total_updates > 0
    assert not torch.distributed.is_initialized()


# -------------------------------------------------------------------- CLI


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.const, a.nargs,
                     a.choices, getattr(a.type, "__name__", a.type))
            for a in parser._actions}


def test_parser_matches_jax_except_device():
    """The JAX parser's options, but ``--device`` (default cuda) and the
    backbone the port alone has, GCNII, among ``--GNN``'s choices."""
    j, t = _actions(jcli.build_parser()), _actions(cli.build_parser())
    assert set(j) == set(t)
    for dest in j:
        if dest == "device":
            assert t[dest][1] == "cuda"
            continue
        if dest == "GNN":
            assert t[dest][4] == j[dest][4] + ["GCNII"]
            assert t[dest][:4] + t[dest][5:] == j[dest][:4] + j[dest][5:]
            continue
        assert t[dest] == j[dest], dest
    args = ["--dataset", "Karate", "--mode", "edge", "--sparse_edge_mlp",
            "true", "--epochs", "3", "--device", "cpu"]
    assert dataclasses.asdict(cli.config_from_args(args)) == \
        dataclasses.asdict(jcli.config_from_args(args))


@pytest.mark.parametrize("mode", ["learned", "random", "edge", "full"])
def test_cli_main_on_karate(capsys, tmp_path, mode):
    cli.main(["--dataset", "Karate", "--mode", mode, "--epochs", "2",
              "--device", "cpu", "--stats", "--log", "true",
              "--results_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[stats] pipeline=two_pass run=0" in out
    assert "---------------Stats-----------" in out
    assert "[fastpath] device=cpu" in out
    rows = _rows(tmp_path / "Karate" / "0.2.csv")
    assert rows[1][3] == mode


def test_cli_devices(tmp_path):
    common = ["--dataset", "Karate", "--epochs", "1", "--results_dir",
              str(tmp_path)]
    cli.main(common + ["--platform", "cpu"])
    for bad in (["--device", "tpu"], ["--platform", "tpu"],
                ["--device", "cpu", "--platform", "gpu"]):
        with pytest.raises(ValueError):
            cli.main(common + bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            cli.main(common)                      # default: cuda
        with pytest.raises(RuntimeError, match="no card"):
            cli.main(common + ["--device", "cuda:0"])

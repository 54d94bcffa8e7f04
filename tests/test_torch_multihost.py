"""Two real port processes on localhost joined by the CLI's ``--multihost
--coordinator_address`` (gloo on the CPU): the twins of
``tests/test_multihost.py`` (:66 partition-parallel, :72 halo).

Each process is ``python -m sgs_gnn_tpu_torch.run.cli`` with its own
``--process_id``; they join one process group, each trains its own
partitions (or its own shard of the halo graph) and every update is
synchronised by the collectives, so the loss rank 0 logs each epoch is
the group's. As in JAX's dry run (tools/multihost_dryrun.py) the gate and
the regularisers are off, so the logged loss is one CE trajectory, which
must fall; rank 1 logs nothing. Marked ``slow``, as the JAX tests are.
"""
import os
import re
import socket
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGS = ("--device", "cpu", "--dataset", "SyntheticSBM", "--nhid", "16",
         "--epochs", "8", "--drop_rate", "0.1", "--conditional", "False",
         "--reg1", "False", "--reg2", "False", "--num_samples_eval", "2",
         "--log", "true", "--save_csv", "false")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp_path, extra):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sgs_gnn_tpu_torch.run.cli", *FLAGS, *extra,
         "--results_dir", str(tmp_path), "--multihost",
         "--coordinator_address", f"localhost:{port}", "--num_processes",
         "2", "--process_id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return procs, outs


def _check(procs, outs, route):
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    epochs = re.findall(r"Epoch (\d+)[^\n]*Loss: ([\d.]+)", outs[0])
    assert f"({route} x2)" in outs[0], outs[0][-3000:]
    losses = [float(v) for _, v in epochs]
    assert len(losses) >= 2 and losses[-1] < losses[0], outs[0][-3000:]
    assert not re.search(r"Epoch \d+", outs[1]), outs[1][-3000:]


@pytest.mark.slow
def test_multihost_parallel_two_processes(tmp_path):
    procs, outs = _run_pair(tmp_path, ("--metis_threshold", "500",
                                       "--data_parallel", "on"))
    _check(procs, outs, "data-parallel")


@pytest.mark.slow
def test_multihost_halo_two_processes(tmp_path):
    procs, outs = _run_pair(tmp_path, ("--halo", "true"))
    _check(procs, outs, "halo")

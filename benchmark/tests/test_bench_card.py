"""On a card: one short run of each cell through ``benchmark/run.py``,
its contract line complete and ``correct`` true. Skips without a card
(decided inside the test)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check"

"""A rehearsal of each traffic mix on the CPU, at a small size, in a fresh
process, loads no module whose top-level name is jax, jaxlib, flax, optax
or sgs_gnn_tpu (names compared whole: sgs_gnn_tpu_torch is the port)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import FORBIDDEN
from benchmark.tests.cpu import small_run
small_run({cell!r}, 5, seconds=0.2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & set(FORBIDDEN))))
"""


def _one_cell_per_mix():
    seen = {}
    for w in BENCH["workloads"]:
        seen.setdefault(w["traffic"], w["name"])
    return sorted(seen.values())


@pytest.mark.parametrize("cell", _one_cell_per_mix())
def test_a_rehearsal_loads_nothing_of_jax(cell):
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=str(ROOT), cell=cell)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_forbidden_names_are_compared_whole():
    from benchmark.harness import FORBIDDEN
    assert "sgs_gnn_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "sgs_gnn_tpu" in FORBIDDEN


def test_the_harness_sources_import_nothing_of_jax():
    import ast
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "optax", "sgs_gnn_tpu"), \
                    (path, n)

#!/usr/bin/env python3
"""Time the row scatter (K1) and the degree sum (K2) of the checkout at ROOT
on one NVIDIA card, on the ids the main paths feed them (``chip_smoke.py``'s
``row_cases``: sampled receivers and senders at q=200k, F=256 and 41, the
sorted sample, E=1M receiver-sorted and unsorted senders): one ``kernel``
line per case, as chip_smoke.py prints them, with the profiler's device
time of the kernel alone (``device_ms``).

    python3 tools/time_row_kernels.py ROOT

The cases, timing and bounds come from this checkout's chip_smoke.py; the
kernels and wrappers from ROOT's ``sgs_gnn_tpu_torch``, whose plain versions
must take ``acc_dtype`` (the checks' f64 reference). For a parent/change
comparison on one card, unpack both commits with ``git archive`` into a
git-ignored directory and run them in turns (parent, change, change,
parent):

    for d in tmp/parent tmp/change tmp/change tmp/parent; do
        python3 tools/time_row_kernels.py $d; done
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

from sgs_gnn_tpu_torch import Graph  # noqa: E402
from sgs_gnn_tpu_torch.data import degree_prior  # noqa: E402
from sgs_gnn_tpu_torch.ops import _build  # noqa: E402

# device functions of K1 and K2 in this and earlier checkouts
FUNCS = {"scatter_add": ("scatter_add_kernel", "scatter_slab_kernel",
                         "scatter_direct_kernel"),
         "segment_sum_scalar": ("segment_sum_smem_kernel",
                                "segment_sum_global_kernel",
                                "segment_sum_kernel")}


def main():
    if not torch.cuda.is_available():
        print("time_row_kernels: no CUDA card", file=sys.stderr)
        return 1
    check = str(Path(_build.__file__).resolve())
    if not check.startswith(str(root)):
        raise RuntimeError(f"the port came from {check}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"root": str(root), "card": smi.stdout.strip(),
                      "library": _build.build().name}), flush=True)
    x, ei, y, tr = cs.build_partition()
    g = Graph.build(x, ei, y, tr, ~tr, None, device="cuda",
                    prob=degree_prior(ei[0], ei[1], cs.N_NODES),
                    sort_by_receiver=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    cs.time_row_kernels(torch, g, gen, FUNCS)
    return 0


if __name__ == "__main__":
    sys.exit(main())

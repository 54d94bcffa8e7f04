#!/usr/bin/env python3
"""Time the fused SpMM (K8) of the checkout at ROOT on one NVIDIA card, on
``chip_smoke.py``'s K8 cases: the bench partition's E=1M receiver-sorted
edge list and its reversal, F=256 and 41, unweighted and weighted, bf16 x,
and the coalesced list (one nonzero per distinct pair). One ``kernel`` line
per case: the route (where ROOT's wrapper counts one), K8's device time
from the profiler (all its kernels), CUDA-event ms over back-to-back
wrapper calls, the error against the plain version, and torch.sparse.mm's
device time on the same nonzeros.

    python3 tools/time_spmm.py ROOT

The cases and timing come from this checkout's chip_smoke.py; the kernels
and wrappers from ROOT's ``sgs_gnn_tpu_torch``. For a parent/change
comparison on one card, unpack both commits with ``git archive`` into a
git-ignored directory and run them in turns (parent, change, change,
parent):

    for d in tmp/parent tmp/change tmp/change tmp/parent; do
        python3 tools/time_spmm.py $d; done
"""
import importlib
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

sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")
# device functions of K8 in this and earlier checkouts
FUNCS = ("spmm_kernel", "spmm_bin_count_kernel", "spmm_bin_scan_kernel",
         "spmm_bin_scatter_kernel", "spmm_tile_kernel")


def csr(s, r, w, dtype):
    """A_w as an f32 CSR with the same nonzeros (duplicates kept)."""
    n = cs.N_NODES
    order = torch.argsort(r, stable=True)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
    crow[1:] = torch.cumsum(torch.bincount(r.long(), minlength=n), 0)
    return torch.sparse_csr_tensor(crow, s.long()[order],
                                   w.to(dtype).float()[order], (n, n))


def time_case(case, s, r, w, x):
    n = cs.N_NODES
    before = dict(_build.ROUTES)
    out = sp._spmm_fused(s, r, w, x, n)
    route = next((rt for (k, rt), v in _build.ROUTES.items()
                  if k == "spmm_fused" and v > before.get((k, rt), 0)),
                 "gather (one route)")
    ref = sp.spmm_fused_plain(s, r, w, x, n)
    tol = cs.sum_tolerance(sp.spmm_fused_plain(s, r, w, x.abs(), n))
    err = (out - ref).abs()
    a_w, xf = csr(s, r, w, x.dtype), x.float()
    dev_ms, by_name = cs.device_ms(
        torch, lambda: sp._spmm_fused(s, r, w, x, n), FUNCS)
    row = dict(root=str(root), case=case, route=route,
               device_ms=dev_ms, device_ms_by_kernel=by_name,
               ms=cs.cuda_ms(torch, lambda: sp._spmm_fused(s, r, w, x, n)),
               max_abs_err=float(err.max()),
               within_tolerance=bool((err <= tol).all()),
               library_device_ms=cs.device_ms(
                   torch, lambda: torch.sparse.mm(a_w, xf), ("",))[0])
    print(json.dumps(row), flush=True)
    return row


def main():
    if not torch.cuda.is_available():
        print("time_spmm: no CUDA card", file=sys.stderr)
        return 1
    check = str(Path(_build.__file__).resolve())
    if not check.startswith(str(root)):
        raise RuntimeError(f"the port came from {check}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"root": str(root), "card": smi.stdout.strip(),
                      "library": _build.build().name}), flush=True)
    x_np, ei, y, tr = cs.build_partition()
    g = Graph.build(x_np, ei, y, tr, ~tr, None, device="cuda",
                    prob=degree_prior(ei[0], ei[1], cs.N_NODES),
                    sort_by_receiver=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for f in (cs.NHID, cs.CLASSES):
        x = torch.randn(cs.N_NODES, f, generator=gen, device="cuda").to(
            torch.bfloat16)
        for weighted in (False, True):
            w = (torch.rand(cs.N_EDGES, generator=gen, device="cuda")
                 if weighted else torch.ones(cs.N_EDGES, device="cuda"))
            kind = "weighted" if weighted else "unweighted"
            for order, s, r in (("receiver-sorted", g.senders, g.receivers),
                                ("reversed", g.receivers, g.senders)):
                rows.append(time_case(f"E=1M F={f} bf16 {kind} {order}",
                                      s, r, w, x))
            if f == cs.NHID and not weighted:
                key = g.receivers.long() * cs.N_NODES + g.senders.long()
                pairs, inv = torch.unique(key, return_inverse=True)
                wu = torch.zeros(pairs.shape[0], device="cuda").index_add_(
                    0, inv, w)
                rows.append(time_case(
                    f"coalesced ({pairs.shape[0]} pairs) F={f} bf16",
                    (pairs % cs.N_NODES).int(), (pairs // cs.N_NODES).int(),
                    wu, x))
    if not all(r["within_tolerance"] for r in rows):
        print("time_spmm: a case is off its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

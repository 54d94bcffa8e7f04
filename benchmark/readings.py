"""The readings the limits in ``limits/<cell>.json`` are set from, many
seeds in one process (set-up is most of a run's time):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--fault half_batch:7,8,9] ...

For each program seed: the set-up and the checked steps, then two
epochs whose last eval is checked (train), or ``kept_from`` requests
(serve); then the numbers compared. For each
control seed: the reference in float8 put in the program's place. For
each fault: the program with the fault planted (``benchmark/faults.py``).
One JSON line per reading on standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def one(cell, seed, kind, fault=None, device="cuda"):
    import torch
    from benchmark import faults, harness, reference
    t0 = time.perf_counter()
    ctx = (faults.FAULTS[fault]() if fault else contextlib.nullcontext())
    with ctx:
        run = harness.Run(cell, seed, device)
        run.setup()
        if cell.traffic["loop"] != "train_epochs":
            run._serve_window(requests=cell.traffic["kept_from"])
        else:       # the eval checked is then a replay, as in the window
            run._train_window(epochs=2)
        run.release()
    kinds = [(kind if fault else "program", {})]
    if kind == "control":
        kinds.append(("control", dict(precision=reference.FP8,
                                      control=True)))
    for k, kw in kinds:
        line = dict(workload=cell.name, seed=seed, kind=k,
                    numbers=run.check(**kw), setup_s=run.setup_s,
                    seconds=time.perf_counter() - t0)
        if device == "cuda":
            line["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", action="append", default=[],
                    help="name:seed,seed,...")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = harness.Cell(args.workload)
    for s in args.seeds:
        one(cell, s, "program")
    for s in args.control:
        one(cell, s, "control")
    for spec in args.fault:
        name, _, ss = spec.partition(":")
        for s in seeds(ss):
            one(cell, s, name, fault=name)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host A/B of a uint16 radix sort in the set-up's stable argsorts on
SyntheticReddit's partitions.

    python3 tools/stable_argsort_ab.py [ROUNDS]

Generates SyntheticReddit once (seed 42, Scripts/run_reddit_scale.sh's
flags, as chip_smoke.py's ``reddit_scale`` phase), then builds its batches
as ``prepare_batches`` does for the card (partition, ``induced_subgraphs``
with the tile index), on the host, in turns: "plain" is the port as it is
(``np.argsort(kind="stable")`` in ``Graph.build``'s receiver order,
``build_tile_index`` and ``part_edge_ids``) and "radix" the same with
keys that all fit 16 bits sorted as uint16 there, which numpy sorts by
radix (the same order). Each round runs radix, plain, plain, radix; one JSON
line per turn (seconds of ``induced_subgraphs`` and of ``part_edge_ids``
within it) and a last line with both variants' turns. Every turn's
batches must equal the first's, array for array, else it exits 1. Host
work only: run it on the card's machine so that its seconds sit beside
the ``reddit_scale`` set-up's.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402


def radix_argsort(keys, kind=None, **kwargs):
    """``np.argsort``, but a stable sort of integer keys that all fit in 16
    bits runs on them cast to uint16 (numpy's radix sort): the same order,
    since the cast keeps every key's rank and ties stay in place."""
    keys = np.asarray(keys)
    if kind == "stable" and keys.dtype.kind in "iu" and keys.size \
            and keys.min() >= 0 and keys.max() <= np.iinfo(np.uint16).max:
        keys = keys.astype(np.uint16)
    return np.argsort(keys, kind=kind, **kwargs)


@contextlib.contextmanager
def radix_sorts():
    """The set-up's modules see a numpy whose argsort is
    ``radix_argsort``."""
    from sgs_gnn_tpu_torch.core import graph
    from sgs_gnn_tpu_torch.data import partition
    from sgs_gnn_tpu_torch.ops import score_tiles
    mods = (graph, partition, score_tiles)
    radix_np = types.SimpleNamespace(**vars(np))
    radix_np.argsort = radix_argsort
    for m in mods:
        m.np = radix_np
    try:
        yield
    finally:
        for m in mods:
            m.np = np


def same_batches(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        (torch.equal(va, vb) if isinstance(va, torch.Tensor) else va == vb)
        for ga, gb in zip(a, b)
        for va, vb in ((v, getattr(gb, f)) for f, v in vars(ga).items()))


def turn(torch, cfg, ds, variant):
    """One build of the batches on the host: (batches, its line)."""
    from sgs_gnn_tpu_torch.data import partition
    from sgs_gnn_tpu_torch.run import driver
    grouping = []
    part_edge_ids = partition.part_edge_ids

    def timed_grouping(*args):
        t0 = time.perf_counter()
        out = part_edge_ids(*args)
        grouping.append(time.perf_counter() - t0)
        return out
    partition.part_edge_ids = timed_grouping
    ctx = radix_sorts() if variant == "radix" else contextlib.nullcontext()
    try:
        with ctx, cs.HostStages(torch) as st:
            driver.prepare_batches(cfg, ds, "cuda", build_device="cpu")
    finally:
        partition.part_edge_ids = part_edge_ids
    return st.batches, dict(
        phase="argsort_turn", variant=variant,
        subgraphs_s=st.seconds["subgraphs"], part_edge_ids_s=sum(grouping),
        graph_build_and_rest_s=st.seconds["subgraphs"] - sum(grouping),
        partition_s=st.seconds["partition"], parts=len(st.batches))


def ab(torch, cfg, ds, rounds=1):
    """``rounds`` of radix, plain, plain, radix: the turns' lines, or None
    where a turn's batches differ from the first turn's."""
    first, lines = None, []
    for _ in range(rounds):
        for variant in ("radix", "plain", "plain", "radix"):
            batches, line = turn(torch, cfg, ds, variant)
            if first is None:
                first = batches
            elif not same_batches(torch, first, batches):
                print(json.dumps(dict(line, error="batches differ")),
                      flush=True)
                return None
            del batches
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 1
    import torch
    from sgs_gnn_tpu_torch.data import registry
    print(json.dumps(dict(host_cores=os.cpu_count(),
                          card=(cs.card_line() if torch.cuda.is_available()
                                else "none"))), flush=True)
    cfg = cs.reddit_config("SyntheticReddit", "learned", cs.REDDIT_EPOCHS)
    t0 = time.perf_counter()
    ds = registry.get_dataset(cfg)
    print(json.dumps(dict(phase="dataset", dataset=ds.name,
                          nodes=ds.num_nodes, edges=ds.num_edges,
                          seconds=time.perf_counter() - t0)), flush=True)
    lines = ab(torch, cfg, ds, rounds)
    if lines is None:
        return 1
    print(json.dumps({"argsort_ab": {
        v: {k: [ln[k] for ln in lines if ln["variant"] == v]
            for k in ("subgraphs_s", "part_edge_ids_s",
                      "graph_build_and_rest_s")}
        for v in ("radix", "plain")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

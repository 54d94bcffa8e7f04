"""Running a cell on the CPU at a small size, for the tests: CUDA graphs
are stood in for by a capture whose replay reruns the captured body, and
the kernels run their plain versions."""
from __future__ import annotations

import collections
import contextlib

import torch

from benchmark import harness

SMALL_GRAPH = dict(num_nodes=900, communities=3, num_parts=3, deg=30)
SMALL_FLAGS = dict(metis_threshold=20000, nhid=32)


class _Rerun:
    def __init__(self, fn):
        self.fn = fn
        self.last = None

    def replay(self):
        self.last = self.fn()


def _rerun_capture(fn, pool=None, generators=()):
    from sgs_gnn_tpu_torch.core import graphed

    class Out(graphed.Captured):
        def replay(self):
            super().replay()
            return self.graph.last
    return Out(_Rerun(fn), None, collections.Counter(),
               collections.Counter(), generators)


@contextlib.contextmanager
def cpu_graphs():
    """The port's graphed route on the CPU (its tests' stand-ins)."""
    from sgs_gnn_tpu_torch.core import graphed
    saved = (graphed.runs_graphs, graphed.capture,
             torch.cuda.graph_pool_handle)
    graphed.runs_graphs = lambda device: True
    graphed.capture = _rerun_capture
    torch.cuda.graph_pool_handle = lambda: None
    try:
        yield
    finally:
        (graphed.runs_graphs, graphed.capture,
         torch.cuda.graph_pool_handle) = saved


def small_run(cell_name, seed, graph=None, flags=None, seconds=0.5):
    """A cell's run on the CPU at a small size, through its check:
    (run, end-to-end metrics, numbers compared)."""
    cell = harness.Cell(cell_name, graph=dict(SMALL_GRAPH, **(graph or {})),
                        flags=dict(SMALL_FLAGS, **(flags or {})))
    cell.traffic = dict(cell.traffic, kept_from=4, kept_requests=3)
    with cpu_graphs():
        run = harness.Run(cell, seed, "cpu")
        run.setup()
        if cell.traffic["loop"] == "train_epochs":
            metrics = run.window(seconds)
        else:       # every kept request completes
            metrics = run._serve_window(requests=cell.traffic["kept_from"])
        run.release()
    return run, metrics, run.check()

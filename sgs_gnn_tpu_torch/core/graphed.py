"""CUDA graphs of the port's per-batch work: the counterpart of the JAX
package's whole-epoch ``lax.scan`` (``train/pipelines.py``
``make_scan_epoch_step``, ``eval/evaluate.py`` ``make_scan_eval_step``)
and of its jitted serving calls (``run/serve.py``).

A captured ``torch.cuda.CUDAGraph`` replays every kernel of a step in one
launch from the host. It replays fixed addresses, so:

  * each shape class (graphs whose tensors all have the same shapes: the
    driver's padded partitions of one edge count) gets one
    :class:`StaticGraph` of input buffers, and a batch's tensors are
    copied into them on the device before its replay; the graphs of one
    class share one memory pool (:class:`ShapeClasses`);
  * the step's state is updated in place (``train/optim.py``), never
    rebound;
  * its random draws come from a ``torch.Generator`` of the graph's own,
    registered with it: a replay reads that generator's seed and offset
    at replay time and advances the offset as the eager call would.
    :class:`Graphs` copies the caller's generator state into it before
    each replay and back after, so the draws are those of the eager call
    with the caller's generator, whichever generator object is passed.

:class:`Graphs` captures each body after one eager run of the same body,
which is the call's own work (the warm-up that capture needs: the kernel
library loaded, the optimizer's moments allocated), and replays it on
every later call with the same key. A capture that fails raises; nothing
falls back to the eager call.

The kernel wrappers count launches on the host (``ops/_build.LAUNCHES``
and ``ROUTES``), and the aggregation the bytes of its message matrices
(``BYTES``). A capture runs nothing, so what its wrappers counted is taken
out of the counters and kept as the graph's tally, and every replay adds
the tally back (:func:`capture`, :class:`Captured`).
The counters then read as they would after the same eager calls. What a
kernel counts on the card (K1's slab chunks per mode) the replay counts
itself.

:func:`run_batch` is the one replay path of the training epoch, the eval
and serving: a batch loaded into its class's buffers, then run or
replayed. :class:`Schedule` is what the epoch and the eval share: a
per-batch loop whose bodies run through :func:`run_batch` on the graphed
route, or on the batch itself on the loop route, adding into one device
sum.

With ``core/spans`` on, :class:`Graphs` runs the eager call in the span
``graph.eager``, the capture in ``graph.capture`` and a replay in
``<name>.replay`` (``name``: ``step``, ``eval`` or ``serve``), counts
``graph.eager_runs``, ``graph.captures`` and ``graph.replays``, and names
the stamps of its bodies by the phase ``name``; :func:`run_batch` opens
``<name>.slot`` and ``<name>.load`` around finding and filling the
buffers; :meth:`StaticGraph.load` counts the bytes it copies in
``graph.load_bytes``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Callable, Dict, Hashable, Optional, Sequence

import torch

from ..ops import _build
from . import spans
from .graph import Graph


def runs_graphs(device) -> bool:
    """Whether the port replays CUDA graphs on ``device``: a CUDA device."""
    return torch.device(device).type == "cuda"


def graph_tensors(g: Graph) -> Dict[str, torch.Tensor]:
    """The tensor fields of ``g`` by name (the tile fields when present)."""
    out = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def shape_key(g: Graph) -> tuple:
    """What a graph captured on ``g``'s buffers fixes: every tensor's
    shape and dtype, the device and the static ints."""
    return (str(g.x.device),
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in graph_tensors(g).items()),
            g.num_classes, g.receiver_band, g.tile_t, g.tile_b)


class StaticGraph:
    """A ``Graph`` of buffers with the shapes of the graph it is made
    from; :meth:`load` copies a graph of the same shapes into them."""

    def __init__(self, g: Graph):
        self.key = shape_key(g)
        self.graph = dataclasses.replace(
            g, **{k: torch.empty_like(v) for k, v in graph_tensors(g).items()})
        self.nbytes = sum(v.nbytes for v in graph_tensors(g).values())

    def load(self, g: Graph) -> Graph:
        """Copy ``g``'s tensors into the buffers (device copies; nothing
        waits) and return the buffers' graph."""
        if shape_key(g) != self.key:
            raise ValueError("load: the graph's shapes differ from the "
                             "buffers'")
        bufs = self.graph
        for k, v in graph_tensors(g).items():
            getattr(bufs, k).copy_(v)
        spans.count("graph.load_bytes", self.nbytes)
        return bufs


class ShapeClasses:
    """One :class:`StaticGraph` and one graph memory pool per shape class,
    made at the class's first graph; every graph captured on a class uses
    both. ``new_pool()`` makes a pool (``torch.cuda.graph_pool_handle``,
    which needs the graph on a CUDA device; a test passes its own)."""

    def __init__(self, new_pool: Optional[Callable[[], Any]] = None):
        self._slots: Dict[tuple, tuple] = {}
        self._new_pool = new_pool

    def slot(self, g: Graph):
        """(buffers, pool) of ``g``'s shape class."""
        key = shape_key(g)
        if key not in self._slots:
            if self._new_pool is None:
                if not runs_graphs(g.x.device):
                    raise ValueError(f"CUDA graphs run on a CUDA device, "
                                     f"not {g.x.device}")
                pool = torch.cuda.graph_pool_handle()
            else:
                pool = self._new_pool()
            self._slots[key] = (StaticGraph(g), pool)
        return self._slots[key]

    def __len__(self) -> int:
        return len(self._slots)


def _diff(after: collections.Counter, before: collections.Counter):
    return collections.Counter({k: v - before[k] for k, v in after.items()
                                if v != before[k]})


class Captured:
    """A captured graph, its static outputs, and the kernel launches its
    capture recorded (``launches`` by kernel, ``routes`` by (kernel,
    route), ``nbytes`` by (kernel, route)); :meth:`replay` adds them to
    ``ops/_build``'s counters."""

    def __init__(self, graph, outputs, launches: collections.Counter,
                 routes: collections.Counter, generators=(),
                 nbytes: Optional[collections.Counter] = None):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.routes = routes
        self.nbytes = collections.Counter() if nbytes is None else nbytes
        self.generators = tuple(generators)   # registered with the graph
        self.replays = 0

    def replay(self):
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        _build.ROUTES.update(self.routes)
        _build.BYTES.update(self.nbytes)
        self.replays += 1
        return self.outputs


def capture(fn: Callable[[], Any], pool=None,
            generators: Sequence[torch.Generator] = (),
            graph=None, context: Optional[Callable] = None) -> Captured:
    """Capture ``fn()`` into a CUDA graph (``graph``, a new
    ``torch.cuda.CUDAGraph`` by default) with ``generators`` registered,
    in the memory ``pool``. The launches, routes and bytes the wrappers
    counted while capturing become the graph's tally and leave the
    counters, also when the capture raises. ``context(graph, pool)`` opens
    the capture (``torch.cuda.graph``; a test passes its own with a fake
    graph)."""
    graph = torch.cuda.CUDAGraph() if graph is None else graph
    for gen in generators:
        graph.register_generator_state(gen)
    if context is None:
        def context(gr, pl):
            return torch.cuda.graph(gr, pool=pl)
    before = [(c, collections.Counter(c)) for c in
              (_build.LAUNCHES, _build.ROUTES, _build.BYTES)]
    try:
        with context(graph, pool):
            outputs = fn()
    finally:
        launches, routes, nbytes = [_diff(c, c0) for c, c0 in before]
        for c, c0 in before:
            c.clear()
            c.update(c0)
    return Captured(graph, outputs, launches, routes, generators=generators,
                    nbytes=nbytes)


class Graphs:
    """Captured graphs by key. :meth:`run` runs a key's body eagerly the
    first time and captures it right after; later calls replay.

    A body draws from the generator it is given. Each key's graph has a
    generator of its own, made at the key's first call and registered with
    the graph; the caller's generator state (seed and offset: host values,
    read and written without touching the device) is copied into it before
    the run and back after, so the caller's generator advances as the
    eager call advances it, and a new generator object on every call
    replays the same graph. ``name`` names the replays' span and the
    bodies' stamps (module docstring)."""

    def __init__(self, capture_fn: Optional[Callable[..., Captured]] = None,
                 name: str = "graph"):
        self.by_key: Dict[Hashable, Captured] = {}
        self._capture = capture if capture_fn is None else capture_fn
        self.name = name
        self._replay_span = f"{name}.replay"

    def run(self, key: Hashable,
            body: Callable[[Optional[torch.Generator]], Any], pool,
            generator: Optional[torch.Generator] = None):
        """``body(generator)``'s outputs: of the eager run at the key's
        first call, else the graph's static outputs after its replay
        (overwritten by the next replay)."""
        cap = self.by_key.get(key)
        own = None
        if generator is not None:
            own = (torch.Generator(device=generator.device) if cap is None
                   else cap.generators[0])
            own.set_state(generator.get_state())
        with spans.phase(self.name):
            if cap is None:
                with spans.span("graph.eager"):
                    out = body(own)
                spans.count("graph.eager_runs")
            else:
                with spans.span(self._replay_span):
                    out = cap.replay()
                spans.count("graph.replays")
        if own is not None:
            generator.set_state(own.get_state())
        if cap is None:
            with spans.phase(self.name), spans.span("graph.capture"):
                self.by_key[key] = self._capture(
                    functools.partial(body, own), pool=pool,
                    generators=() if own is None else (own,))
            spans.count("graph.captures")
        return out

    @property
    def replays(self) -> int:
        return sum(c.replays for c in self.by_key.values())

    def __len__(self) -> int:
        return len(self.by_key)


def run_batch(classes: ShapeClasses, graphs: Graphs, g: Graph, key_extra,
              body: Callable[[Graph, Optional[torch.Generator]], Any],
              generator: Optional[torch.Generator] = None):
    """``body(buffers, generator)`` for the batch ``g``: its tensors
    copied into its shape class's buffers, then the graph keyed by (class,
    ``key_extra``) run eagerly and captured at the key's first call, else
    replayed (:meth:`Graphs.run`, whose outputs it returns)."""
    with spans.span(f"{graphs.name}.slot"):
        bufs, pool = classes.slot(g)
    with spans.span(f"{graphs.name}.load"):
        static = bufs.load(g)
    return graphs.run((bufs.key, key_extra), functools.partial(body, static),
                      pool, generator)


class Schedule:
    """A per-batch schedule on one of two routes, the same batches, draws
    and sums on both: the graphed route runs each batch's body through
    :func:`run_batch` (``classes``, a new :class:`ShapeClasses` by default;
    ``graphs``, named ``name``); the loop route (``loop``) calls the body
    on the batch itself, with no buffers and no capture, in the stamps'
    phase ``name``. ``acc`` is a device vector of ``width`` sums that the
    bodies add into, zeroed at the start of each call (:meth:`_zeroed`);
    its address stays fixed for the graphs."""

    def __init__(self, name: str, width: int,
                 classes: Optional[ShapeClasses] = None, loop: bool = False):
        self.name, self.width = name, width
        self.classes = ShapeClasses() if classes is None else classes
        self.graphs = None if loop else Graphs(name=name)
        self.acc = None

    def _zeroed(self, device) -> torch.Tensor:
        if self.acc is None:
            self.acc = torch.zeros(self.width, device=device)
        return self.acc.zero_()

    def _run(self, g: Graph, key_extra, body, generator: torch.Generator):
        if self.graphs is None:
            with spans.phase(self.name):
                return body(g, generator)
        return run_batch(self.classes, self.graphs, g, key_extra, body,
                         generator)

"""Spans, counters and device stamps of the port: where its time goes.

Off by default. Off, :func:`span` returns one shared ``nullcontext`` and
:func:`count`, :func:`stamp` and :func:`boundary` return at once: one
module-level bool check each, no allocation, no device work, never a
synchronise. :func:`enable` turns them on:

  * **Host spans.** ``with span(name, id):`` enters
    ``torch.profiler.record_function("sgs." + name)``, so the span lies on
    the profiler's timeline on the clock of the CUDA activity, and appends
    ``(name, id, parent, t0_ns, t1_ns)`` to an in-memory list (``parent``:
    the index of the innermost span open at entry, or None).
    :func:`collect` sums each name's calls, total and self time (total
    less its children's).
  * **Counters.** ``count(name, n)``. The kernel wrappers' launch counts,
    ``LAUNCHES`` (per kernel) and ``ROUTES`` (per kernel and route), live
    here too and count whether or not the module is on
    (``ops/_build`` keeps its names for them). ``ROUTES[("spmm", route)]``
    counts the aggregation's calls per route (``ops/spmm.py``
    ``auto_route``: "k8_tiles" or "gather_k1"), not launches. ``BYTES``
    counts bytes per (kernel, route) alike: ``BYTES[("spmm",
    "gather_k1")]`` the (E, F) message matrices that route writes in its
    forward, E x F x itemsize a call (nothing on "k8_tiles").
  * **Device stamps** (``enable(device_stamps=True)``). ``stamp(segment,
    device)`` enqueues a one-thread kernel (``csrc/stamp.cu``) on the
    device's current stream: it reads the device's ``%globaltimer`` and
    adds the time since the previous stamp to ``segment``'s total, so a
    stamp at the end of a piece of work credits that work. Stamps enqueued
    while a CUDA graph is captured are nodes of the graph and run on every
    replay: device time per layer inside the graphs, with no host
    synchronise. Segments are named ``<phase>.<segment>``, the phase being
    the kind of graph being run or captured (``phase``: ``step``, ``eval``,
    ``serve``), so the same layer is kept apart per graph. On the CPU a
    stamp does nothing. :func:`boundary` splits a backward pass: an
    identity whose backward stamps. :func:`collect` reads the totals once,
    after the caller has synchronised.

With stamps off the port's graphs are the graphs it captures without this
module. Turn stamps on before the first call of a graphed step (the eager
call that precedes its capture): the accumulators are allocated at the
first stamp, outside any capture.

:func:`label_gaps` puts the device's idle stretches of a profiled stretch
down to the innermost host span around each, by the profiler's events.
This module imports nothing of the port at its top (``ops/_build`` and
``core/graphed`` import it); the stamp's library is loaded at the first
stamp.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PREFIX = "sgs."
ON = False                  # host spans and counters
STAMPS = False              # device stamps
MAX_SEGMENTS = 64           # rows of a device's accumulator

LAUNCHES: collections.Counter = collections.Counter()
ROUTES: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()

_NULL = contextlib.nullcontext()
_records: List[list] = []   # [name, id, parent, t0_ns, t1_ns]
_open: List[int] = []       # indices of the open spans, innermost last
_counters: collections.Counter = collections.Counter()
_launches0: collections.Counter = collections.Counter()
_routes0: collections.Counter = collections.Counter()
_bytes0: collections.Counter = collections.Counter()
_generation = 0             # bumped by reset(): spans opened before it
_phase = ""
_rows: Dict[str, int] = {}  # segment -> accumulator row
_acc: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}   # device index ->
# (totals and stamp counts (MAX_SEGMENTS, 2) int64, last stamp (1,) int64)


def enable(device_stamps: bool = False) -> None:
    """Turn host spans and counters on, and device stamps with
    ``device_stamps``."""
    global ON, STAMPS
    ON, STAMPS = True, bool(device_stamps)


def disable() -> None:
    """Turn everything off (what was recorded stays until :func:`reset`)."""
    global ON, STAMPS
    ON = STAMPS = False


def reset() -> None:
    """Forget the spans and counters recorded so far and zero the device
    accumulators in place (device memsets; the graphs keep their
    addresses). Spans open now are not recorded."""
    global _generation
    _records.clear()
    _open.clear()
    _counters.clear()
    _launches0.clear()
    _launches0.update(LAUNCHES)
    _routes0.clear()
    _routes0.update(ROUTES)
    _bytes0.clear()
    _bytes0.update(BYTES)
    _generation += 1
    for acc, last in _acc.values():
        acc.zero_()
        last.zero_()


class _Span:
    __slots__ = ("name", "id", "_rf", "_i", "_gen")

    def __init__(self, name: str, id_):
        self.name, self.id = name, id_

    def __enter__(self):
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        self._gen = _generation
        self._i = len(_records)
        _records.append([self.name, self.id, _open[-1] if _open else None,
                         time.perf_counter_ns(), None])
        _open.append(self._i)
        return self

    def __exit__(self, *exc):
        if self._gen == _generation:
            _records[self._i][4] = time.perf_counter_ns()
            _open.remove(self._i)
        self._rf.__exit__(*exc)
        return False


def span(name: str, id=None):
    """A host span named ``sgs.<name>`` (module docstring); ``id`` tells
    calls apart (an epoch and batch, a request number)."""
    if not ON:
        return _NULL
    return _Span(name, id)


def count(name: str, n: int = 1) -> None:
    if ON:
        _counters[name] += n


@contextlib.contextmanager
def _phase_ctx(name: str):
    global _phase
    before, _phase = _phase, name
    try:
        yield
    finally:
        _phase = before


def phase(name: str):
    """Stamps enqueued inside are named ``<name>.<segment>``."""
    if not STAMPS:
        return _NULL
    return _phase_ctx(name)


def _buffers(device: torch.device):
    bufs = _acc.get(device.index)
    if bufs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("spans: the first device stamp is being "
                               "captured; enable stamps before the first "
                               "(eager) call of a graphed step")
        bufs = _acc[device.index] = (
            torch.zeros((MAX_SEGMENTS, 2), dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))
    return bufs


def _launch(name: str, device) -> None:
    device = torch.device(device)
    if device.type != "cuda":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    row = _rows.get(name)
    if row is None:
        if len(_rows) >= MAX_SEGMENTS:
            raise RuntimeError(f"spans: more than {MAX_SEGMENTS} segments")
        row = _rows[name] = len(_rows)
    acc, last = _buffers(device)
    from ..ops._build import library
    lib = library()
    with torch.cuda.device(device):
        err = lib.sgs_stamp(acc.data_ptr(), last.data_ptr(), row,
                            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stamp: CUDA error {err} "
                           f"({lib.sgs_error_string(err).decode()})")


def _qualified(segment: str) -> str:
    return f"{_phase}.{segment}" if _phase else segment


def stamp(segment: str, device) -> None:
    """Credit the device time since the previous stamp to ``segment``
    (module docstring); nothing on a CPU ``device``."""
    if STAMPS:
        _launch(_qualified(segment), device)


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _launch(ctx.name, grad.device)
        return grad, None


def boundary(x: torch.Tensor, segment: str) -> torch.Tensor:
    """``x``; with stamps on, ``x`` through an identity whose backward
    stamps ``segment`` when the gradient reaches ``x`` (a view: no device
    work), which credits the backward of what consumed ``x`` to
    ``segment``."""
    if not STAMPS or not x.requires_grad:
        return x
    return _Boundary.apply(x, _qualified(segment))


def collect() -> dict:
    """What was recorded since the last :func:`reset`: ``spans`` (name ->
    calls, total_s, self_s), ``records`` (name, id, parent, t0_ns, t1_ns;
    finished spans), ``counters`` (name -> count; the kernel launches as
    ``kernels.launches.<kernel>``, the routes as
    ``kernels.routes.<kernel>.<route>``, the bytes as
    ``kernels.bytes.<kernel>.<route>``) and ``segments`` (name -> stamps,
    seconds). Reads the device accumulators: synchronise first."""
    done = [r for r in _records if r[4] is not None]
    child_ns = collections.Counter()
    for _, _, parent, t0, t1 in done:
        if parent is not None:
            child_ns[parent] += t1 - t0
    spans: Dict[str, dict] = {}
    for i, (name, _, _, t0, t1) in enumerate(_records):
        if t1 is None:
            continue
        s = spans.setdefault(name, {"calls": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        s["calls"] += 1
        s["total_s"] += (t1 - t0) / 1e9
        s["self_s"] += (t1 - t0 - child_ns[i]) / 1e9
    counters = dict(_counters)
    for k, v in LAUNCHES.items():
        if v != _launches0[k]:
            counters[f"kernels.launches.{k}"] = v - _launches0[k]
    for (k, route), v in ROUTES.items():
        if v != _routes0[k, route]:
            counters[f"kernels.routes.{k}.{route}"] = v - _routes0[k, route]
    for (k, route), v in BYTES.items():
        if v != _bytes0[k, route]:
            counters[f"kernels.bytes.{k}.{route}"] = v - _bytes0[k, route]
    segments: Dict[str, dict] = {}
    tables = [acc.cpu() for acc, _ in _acc.values()]
    for name, row in _rows.items():
        ns = sum(int(t[row, 0]) for t in tables)
        n = sum(int(t[row, 1]) for t in tables)
        if n:
            segments[name] = {"stamps": n, "s": ns / 1e9}
    return {"spans": spans, "records": [tuple(r) for r in done],
            "counters": counters, "segments": segments}


def report_lines(result: dict) -> List[str]:
    """``collect()``'s tables as log lines: spans by self time, then the
    stamped segments, then the counters."""
    lines = [f"[spans] {k} calls={v['calls']} total_ms="
             f"{v['total_s'] * 1e3:.3f} self_ms={v['self_s'] * 1e3:.3f}"
             for k, v in sorted(result["spans"].items(),
                                key=lambda kv: -kv[1]["self_s"])]
    lines += [f"[stamps] {k} stamps={v['stamps']} ms={v['s'] * 1e3:.3f}"
              for k, v in sorted(result["segments"].items())]
    lines += [f"[counters] {k}={v}"
              for k, v in sorted(result["counters"].items())]
    return lines


def label_gaps(busy: Iterable[Tuple[float, float]],
               host: Iterable[Tuple[str, float, float]],
               lo: Optional[float] = None,
               hi: Optional[float] = None) -> Dict[str, float]:
    """The device's idle stretches, in seconds, summed by the innermost
    host span around each stretch's middle, or ``outside`` where none
    covers it. ``busy``: the device's busy intervals (start, end) in
    microseconds, merged (the union of its operations); ``host``: (label,
    start, end) in microseconds on the same clock; ``lo`` and ``hi`` add
    the stretches before the first and after the last busy interval."""
    host = list(host)
    edges = ([[lo, lo]] if lo is not None else []) + \
        [list(b) for b in sorted(busy)] + ([[hi, hi]] if hi is not None
                                           else [])
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            mid = (a + b) / 2
            cover = [h for h in host if h[1] <= mid <= h[2]]
            label = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                     else "outside")
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return gaps

"""Segment profiler (port of ``utils/profiler.py``), run by
``--gpu_profile``: the reference's GpuMemoryProfiler (reference
utils.py:13-79, printed main.py:171-207) with its four named segments.

Each segment runs eagerly on its own, bracketed by synchronizations of
the card. Its time is the wall clock between them; its memory is what the
reference measures: the peak allocated during the segment above what was
allocated before it (``reset_peak_memory_stats`` before the segment,
``max_memory_allocated`` after). Under XLA the JAX package could not see
per-segment memory inside one fused executable; on the card it can.

For deep dives, ``trace`` records a ``torch.profiler`` Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..sparsify.sampling import sample_edges, sample_prior_edges
from ..train.losses import masked_cross_entropy
from ..train.pipelines import make_learned_loss

MIB = 1024 ** 2


def device_memory_mb(device) -> Optional[Dict[str, float]]:
    """Allocated, peak allocated and total memory of a CUDA ``device`` in
    MiB (``allocated_mb``, ``peak_mb``, ``limit_mb``); None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dict(allocated_mb=torch.cuda.memory_allocated(dev) / MIB,
                peak_mb=torch.cuda.max_memory_allocated(dev) / MIB,
                limit_mb=torch.cuda.mem_get_info(dev)[1] / MIB)


def _sync(out) -> None:
    """Wait for the cards that hold ``out``'s tensors (nested lists,
    tuples and dicts)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: wall time over ``iters`` calls
    after ``warmup``, each call's output synchronized."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _sync(fn(*args))
    return (time.perf_counter() - t0) / iters


class SegmentTimer:
    """Named-segment wall timer with the reference's four segment names;
    aggregates as GpuMemoryProfiler.summarize_epoch does."""

    SEGMENTS = ("edge_mlp_pre", "edge_score", "gnn_forward", "backward")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._records: Dict[str, list] = {}

    def record(self, name: str, seconds: float):
        if self.enabled:
            self._records.setdefault(name, []).append(seconds)

    def time_segment(self, name: str, fn: Callable, *args, iters: int = 3):
        if not self.enabled:
            return None
        dt = timed(fn, *args, iters=iters)
        self.record(name, dt)
        return dt

    def summarize(self) -> Dict[str, Dict[str, float]]:
        return {name: dict(mean_ms=float(np.mean(rows)) * 1e3,
                           max_ms=float(np.max(rows)) * 1e3,
                           calls=len(rows))
                for name, rows in self._records.items()}

    def report(self, prefix: str = "[profile]", log_fn=print):
        parts = [f"{n}: mean_ms={v['mean_ms']:.2f} max_ms={v['max_ms']:.2f} "
                 f"calls={v['calls']}" for n, v in self.summarize().items()]
        log_fn(f"{prefix} " + " | ".join(parts))


class SegmentProfiler:
    """``profile(g, generator) -> (ms, mb)`` by segment name
    (``SegmentTimer.SEGMENTS``); see ``make_segment_profiler``.

    Each segment resets the card's peak statistics, which would hide the
    run's peak from a later ``max_memory_allocated``: ``peak_mb`` keeps
    the highest peak read before any of this profiler's resets, so the
    run's peak is the larger of the two."""

    def __init__(self, cfg, model, q: int):
        self.cfg, self.model, self.q = cfg, model, q
        self.learned = cfg.mode == "learned"
        self.use_rand = cfg.conditional or cfg.sparse_edge_mlp
        self.loss_fn = make_learned_loss(cfg, model, q) if self.learned \
            else None
        self.peak_mb = 0.0

    def _call(self, dev, fn, *args):
        """``fn(*args)`` on ``dev`` -> (output, ms, MiB above the
        allocation before it at its peak; 0 on the CPU)."""
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            self.peak_mb = max(self.peak_mb,
                               torch.cuda.max_memory_allocated(dev) / MIB)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        mb = ((torch.cuda.max_memory_allocated(dev) - before) / MIB
              if cuda else 0.0)
        return out, ms, mb

    def _pre(self, g, gen):
        s, r = g.senders, g.receivers
        if self.learned and self.use_rand and g.num_edges > self.q:
            idx = sample_prior_edges(gen, g.prob, self.q, g.edge_mask).long()
            s, r = s[idx], r[idx]
        with torch.no_grad():
            return self.model.encode_scorer(g.x, s, r, deterministic=False,
                                            generator=gen)

    def _score(self, h, g, gen):
        with torch.no_grad():
            return self.model.score_from_embeddings(
                h, g.senders, g.receivers, deterministic=False,
                generator=gen)

    def _sample(self, probs, g, gen):
        if g.num_edges <= self.q:
            return g.senders, g.receivers
        idx, _ = sample_edges(gen, probs, g.prob, self.q,
                              self.cfg.degree_bias_coef,
                              edge_mask=g.edge_mask)
        idx = idx.long()
        return g.senders[idx], g.receivers[idx]

    def _gnn(self, g, s, r, gen):
        with torch.no_grad():
            return self.model(g.x, s, r, None, deterministic=False,
                              generator=gen)

    def _backward(self, g, gen):
        if self.learned and g.num_edges > self.q:
            loss, _ = self.loss_fn(g, gen)
        else:
            out = self.model(g.x, g.senders, g.receivers, None,
                             deterministic=False, generator=gen)
            loss = masked_cross_entropy(out, g.y, g.train_mask)
        params = [p for p in self.model.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return sum(gr.float().sum() for gr in grads if gr is not None)

    def __call__(self, g, generator: torch.Generator):
        dev = g.x.device
        ms, mb = {}, {}
        if self.learned:
            h, ms["edge_mlp_pre"], mb["edge_mlp_pre"] = self._call(
                dev, self._pre, g, generator)
            probs, ms["edge_score"], mb["edge_score"] = self._call(
                dev, self._score, h, g, generator)
            del h
            s, r = self._sample(probs, g, generator)
        else:
            ms["edge_mlp_pre"] = ms["edge_score"] = 0.0
            mb["edge_mlp_pre"] = mb["edge_score"] = 0.0
            s, r = g.senders, g.receivers
        _, ms["gnn_forward"], mb["gnn_forward"] = self._call(
            dev, self._gnn, g, s, r, generator)
        _, ms["backward"], mb["backward"] = self._call(
            dev, self._backward, g, generator)
        return ms, mb


def make_segment_profiler(cfg, model, q: int) -> SegmentProfiler:
    """Per-epoch segment breakdown for ``--gpu_profile``, with the
    reference's segment names: ``edge_mlp_pre`` (the scorer's encoder on
    its propagation edges: the degree-prior q-subgraph with conditional or
    sparse_edge_mlp), ``edge_score`` (the score head over every edge),
    ``gnn_forward`` (the backbone on the q edges sampled from those
    scores) and ``backward`` (the gradients of the mode's training loss:
    the learned step's, else the backbone's CE on the whole graph). The
    forward segments run without autograd; outside the learned mode the
    scorer's segments report 0. Nothing is updated.

    Returns ``profile(g, generator) -> ({segment: ms}, {segment: MiB})``;
    on the CPU every MiB is 0."""
    return SegmentProfiler(cfg, model, q)


@contextlib.contextmanager
def trace(logdir: str = "traces"):
    """``torch.profiler`` over the block (the host, and the card where
    there is one); writes ``logdir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

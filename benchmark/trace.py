"""Reading a ``torch.profiler`` trace of a stretch of the window: device
time by kernel name, device busy time (the union of the intervals in
which an operation ran on the card), the idle gaps labelled by what the
harness, and apart by what the program, was doing on the host, and the
program's own record of the stretch. A copy, widened, of
``chip_smoke.py``'s ``profile_breakdown``."""
from __future__ import annotations

import time

SPAN_PREFIX = "bench."
STAMP_KERNEL = "stamp_kernel"   # the program's device stamp (csrc/stamp.cu)


def span(torch, name):
    """A host span of the harness, named in the trace as bench.<name>."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _union(intervals):
    merged = []
    for st, en in sorted(intervals):
        if merged and st <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([st, en])
    return merged


class Trace:
    """What one traced stretch showed. Times in seconds."""

    def __init__(self, kernels, busy_s, window_s, gaps, program=None,
                 program_gaps=None):
        self.kernels = kernels      # name -> [launches, device seconds]
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps            # host span -> idle seconds in it
        self.program = program      # the program's record of the stretch
        self.program_gaps = program_gaps or {}  # program span -> idle s

    def kernel_seconds(self, names):
        """Device seconds and launches of the kernels whose profiler name
        holds one of ``names``."""
        sec = n = 0
        for k, (cnt, s) in self.kernels.items():
            if any(x in k for x in names):
                sec += s
                n += cnt
        return sec, n

    def unmatched(self, names, top=5):
        """The longest kernels whose names hold none of ``names``."""
        rest = [(k, v[1]) for k, v in self.kernels.items()
                if not any(x in k for x in names)]
        return sorted(rest, key=lambda kv: -kv[1])[:top]

    def device_ops(self, top=10):
        return [[k, v[1]] for k, v in sorted(self.kernels.items(),
                                               key=lambda kv: -kv[1][1])[:top]]


def label_gaps(busy, host, lo, hi):
    """Idle seconds between the merged ``busy`` intervals (and, where
    ``lo`` / ``hi`` are given, before the first and after the last),
    summed by the innermost of the ``host`` spans (label, start, end)
    around each gap's middle, or ``outside``. Microseconds in."""
    edges = ([[lo, lo]] if lo is not None else []) + list(busy) \
        + ([[hi, hi]] if hi is not None else [])
    gaps = {}
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            mid = (a + b) / 2
            cover = [h for h in host if h[1] <= mid <= h[2]]
            label = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                     else "outside")
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return gaps


def traced(torch, fn):
    """Run ``fn()`` under the profiler, the card synchronised on both
    sides; the window is the host clock around ``fn()`` and its final
    synchronisation. Idle gaps (and the stretch before the first and after
    the last device operation) are summed by the innermost harness span
    around their middle, and apart by the innermost program span. The
    program's record (``core/spans.py``: spans, counters, stamped
    segments) is reset before the stretch and collected after it; its
    device annotations and stamp kernels are no device work here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sgs_gnn_tpu_torch.core import spans
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span(torch, "window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    program = spans.collect()
    events = list(prof.events())
    # the harness's and the program's spans also appear on the device's
    # timeline (annotations): only kernels, copies and fills count
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith((SPAN_PREFIX, spans.PREFIX))
           and STAMP_KERNEL not in e.name]
    kernels = {}
    for e in dev:
        name = e.name[:120]
        rec = kernels.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e6
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(en - st for st, en in merged) / 1e6
    host = [e for e in events if e.device_type != DeviceType.CUDA]

    def labelled(prefix):
        return [(e.name[len(prefix):], e.time_range.start,
                 e.time_range.end) for e in host if e.name.startswith(prefix)]
    win = [e for e in host if e.name == SPAN_PREFIX + "window"]
    lo = min((e.time_range.start for e in win), default=None)
    hi = max((e.time_range.end for e in win), default=None)
    return Trace(kernels, busy, window_s,
                 label_gaps(merged, labelled(SPAN_PREFIX), lo, hi),
                 program, label_gaps(merged, labelled(spans.PREFIX), lo, hi))

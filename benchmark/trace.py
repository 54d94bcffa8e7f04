"""Reading a ``torch.profiler`` trace of a stretch of the window: device
time by kernel name, device busy time (the union of the intervals in
which an operation ran on the card) and the idle gaps labelled by what the
harness was doing on the host. A copy, widened, of ``chip_smoke.py``'s
``profile_breakdown``."""
from __future__ import annotations

import time

SPAN_PREFIX = "bench."


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

    def __init__(self, kernels, busy_s, window_s, gaps):
        self.kernels = kernels      # name -> [launches, device seconds]
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps            # host span -> idle seconds in it

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


def traced(torch, fn):
    """Run ``fn()`` under the profiler, the card synchronised on both
    sides; the window is the host clock around ``fn()`` and its final
    synchronisation. Idle gaps (and the stretch before the first and after
    the last device operation) are summed by the innermost harness span
    around their middle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span(torch, "window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = list(prof.events())
    # the harness's spans also appear on the device's timeline
    # (annotations): only kernels, copies and fills count
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(SPAN_PREFIX)]
    kernels = {}
    for e in dev:
        name = e.name[:120]
        rec = kernels.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e6
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(en - st for st, en in merged) / 1e6
    host = [e for e in events if e.device_type != DeviceType.CUDA
            and e.name.startswith(SPAN_PREFIX)]
    win = [e for e in host if e.name == SPAN_PREFIX + "window"]
    lo = min((e.time_range.start for e in win), default=None)
    hi = max((e.time_range.end for e in win), default=None)
    edges = ([[lo, lo]] if lo is not None else []) + merged \
        + ([[hi, hi]] if hi is not None else [])
    gaps = {}
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            mid = (a + b) / 2
            cover = [e for e in host if e.time_range.start <= mid
                     <= e.time_range.end]
            label = (min(cover, key=lambda e: e.time_range.elapsed_us())
                     .name[len(SPAN_PREFIX):] if cover else "outside")
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return Trace(kernels, busy, window_s, gaps)

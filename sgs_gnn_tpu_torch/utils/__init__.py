"""Diagnostics (port of ``utils/``): the segment profiler of
``--gpu_profile`` and the debug checks of ``--debug_checks``. The JAX
package's compilation cache (``utils/compcache.py``) has no counterpart."""
from .debug import checked, find_nans, validate_graph
from .profiler import (SegmentTimer, device_memory_mb,
                       make_segment_profiler, timed, trace)

__all__ = ["device_memory_mb", "timed", "SegmentTimer",
           "make_segment_profiler", "trace", "validate_graph", "checked",
           "find_nans"]

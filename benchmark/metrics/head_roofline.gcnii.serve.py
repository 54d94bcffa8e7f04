"""head_roofline.gcnii.serve: ``head_roofline.serve`` in the GCNII serving
cell: K3 over every valid edge of each traced request at the bf16 peak,
over the head kernel's device time, in %."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_head_roofline_serve_base",
    Path(__file__).with_name("head_roofline.serve.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read

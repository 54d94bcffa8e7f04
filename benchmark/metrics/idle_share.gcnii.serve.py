"""idle_share.gcnii.serve: ``idle_share.serve`` in the GCNII serving cell:
the share of the traced requests in which no operation ran on the card,
in %."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_idle_share_serve_base",
    Path(__file__).with_name("idle_share.serve.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read

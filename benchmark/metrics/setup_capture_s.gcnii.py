"""setup_capture_s.gcnii: ``setup_capture_s`` in the GCNII serving cell:
seconds from the first serving call to the last capture."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_setup_capture_s_base",
    Path(__file__).with_name("setup_capture_s.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read

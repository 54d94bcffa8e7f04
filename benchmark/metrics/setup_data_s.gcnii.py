"""setup_data_s.gcnii: ``setup_data_s`` in the GCNII serving cell: host
seconds of the port's ``prepare_batches``."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_setup_data_s_base",
    Path(__file__).with_name("setup_data_s.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read

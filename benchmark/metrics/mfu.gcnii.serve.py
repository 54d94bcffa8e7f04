"""mfu.gcnii.serve: ``mfu.serve`` in the GCNII serving cell: the model
operations of the traced requests (the GCN scorer and K3 over every valid
edge, one GCNII forward per draw: 9 propagations and 9 2048 x 2048
products; the frozen count of ``benchmark/archs/``) over (window x the
bf16 peak), in %."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_mfu_serve_base",
    Path(__file__).with_name("mfu.serve.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read

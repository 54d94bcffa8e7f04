"""mfu.gin_mlp.train: ``mfu.train`` in the GIN + MLP training cell: the
model operations of the traced epochs (every sampled step and every
partition's eval; the frozen count of ``benchmark/archs/``) over
(window x the bf16 peak), in %."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_mfu_train_base",
    Path(__file__).with_name("mfu.train.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read

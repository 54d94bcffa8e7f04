from .config import Config
from .device import resolve_device, torch_dtype
from .graph import Graph

__all__ = ["Config", "Graph", "resolve_device", "torch_dtype"]

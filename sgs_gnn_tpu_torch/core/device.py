"""Device and dtype resolution shared by the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``. Asking
for CUDA on a machine without a card raises: the port never falls back to
the CPU on its own, so a run on the CPU is always one the caller asked for.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but torch.cuda reports no "
            "card; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """Compute dtype from a ``Config.dtype`` string or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise ValueError(f"dtype {dtype} must be float32|bfloat16")
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"dtype={dtype!r} must be float32|bfloat16")
    return _DTYPES[dtype]

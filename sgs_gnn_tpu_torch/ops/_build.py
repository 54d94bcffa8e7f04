"""Build, load and call the port's hand-written CUDA kernels.

The sources under ``sgs_gnn_tpu_torch/csrc/`` have a plain C interface. At
first use on a card they are compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together, then one link) into a single
shared library under ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, and loaded with ``ctypes``. Nothing is
compiled at import time: the CPU never needs the library.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``; a plain ``int`` would cut a 64-bit pointer), launches
on PyTorch's current stream and returns ``cudaGetLastError()``;
:func:`call` raises when that is not 0.

``LAUNCHES`` counts, per kernel name, the launches the wrappers made. A run
resets it (``LAUNCHES.clear()``) and reads it afterwards to show that a path
went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("scatter.cu", "segment_sum.cu", "score_sampled.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: name -> argtypes (every function returns cudaError_t as int)
_SIGNATURES = {
    "sgs_scatter_add": [_P, _I, _P, _P, _L, _I, _I, _P],
    "sgs_segment_sum_scalar": [_P, _P, _P, _L, _I, _P],
    "sgs_score_head_fwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _L, _I, _I, _I, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (PATH, or {home}/bin/nvcc); the "
                           "CUDA kernels are built on the machine with the card")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + tuple(sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Compiler output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it in ``<lib>.log``."""
    lib = BUILD_DIR / f"libsgs_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    Path(f"{lib}.log").write_text("\n".join(log))
    os.replace(tmp, lib)     # atomic: a concurrent build never sees half a file
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sgs_error_string.argtypes = [ctypes.c_int]
    lib.sgs_error_string.restype = ctypes.c_char_p
    return lib


def call(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Launch ``fn_name`` on ``device``'s current stream, raise on a CUDA
    error, and count the launch under ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.sgs_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one card and no autograd
    (their backward comes with the training slice)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: the CUDA kernel has no backward yet; call it under "
                "torch.no_grad()")

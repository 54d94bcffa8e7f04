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
went through the kernels. ``ROUTES`` counts them per (kernel, route) where a
wrapper dispatches one kernel name to several routes (K1: "slab" or
"direct", K2: "shared" or "global", by ``ops/scatter.py``'s plans; K5:
"tensor_cores" for bf16 h, "cuda_cores" for f32; K8: "tiles" or "gather",
by ``ops/spmm.py`` ``spmm_plan``; the ordered top-q draw "topq":
"gumbel" or "uniform", its key formula, counted on the CPU too);
``ops/spmm.py`` adds ("spmm", route),
calls of its "auto" backend per route, which launch no kernel of that
name. What a kernel picks from
the data, not the host, it counts on the card itself (K1's slab chunks per
mode: ``ops/scatter.py`` ``slab_chunk_modes``; the draws that broke a tie
at the threshold: ``ops/sampling_ops.py`` ``topq_ties``). ``BYTES`` counts
bytes per (kernel, route): ("spmm", "gather_k1"), the message matrices of the
"auto" backend's gather route. The three counters are ``core/spans.py``'s
``LAUNCHES``, ``ROUTES`` and ``BYTES`` (the same objects). With
``core/spans`` on, the compile is the span ``kernels.build`` (counted in
``kernels.builds``) and the library's load the span ``kernels.load``.
``csrc/stamp.cu`` is ``core/spans.py``'s device stamp, launched there and
not counted here.
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

from ..core import spans

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("scatter.cu", "segment_sum.cu", "score_sampled.cu",
           "score_tiles.cu", "scatter_sorted.cu", "spmm.cu", "stamp.cu",
           "topq.cu", "rows_at.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the counters live in core/spans.py (the same objects)
LAUNCHES: collections.Counter = spans.LAUNCHES
ROUTES: collections.Counter = spans.ROUTES
BYTES: collections.Counter = spans.BYTES

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
# C signatures: name -> argtypes (every function returns cudaError_t as int)
_SIGNATURES = {
    "sgs_scatter_add": [_P, _I, _P, _P, _L, _I, _I, _I, _I, _L, _I, _I,
                        _P, _P],
    "sgs_segment_sum_scalar": [_P, _P, _P, _L, _I, _L, _P],
    "sgs_score_head_fwd": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _U, _F, _P, _L, _I, _I, _I, _P],
    "sgs_score_head_bwd": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _U, _F, _P, _P, _P, _P, _P, _P, _P, _L,
                           _I, _I, _I, _P],
    "sgs_score_head_tiles": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _P, _U, _F, _P, _L, _I, _I, _I,
                             _P],
    "sgs_dropout_bits": [_P, _P, _P, _L, _P],
    "sgs_scatter_add_sorted": [_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "sgs_spmm_fused": [_P, _P, _P, _P, _I, _P, _L, _I, _I, _I, _I, _P, _P],
    "sgs_stamp": [_P, _P, _I, _P],
    "sgs_topq": [_P, _P, _P, _L, _L, _P, _L, _P, _P],
    "sgs_rows_at": [_P, _P, _P, _I, _L, _I, _I, _I, _P],
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
    with spans.span("kernels.build"):
        _compile(lib)
    spans.count("kernels.builds")
    return lib


def _compile(lib: Path) -> None:
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


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    path = build()
    with spans.span("kernels.load"):
        lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sgs_error_string.argtypes = [ctypes.c_int]
    lib.sgs_error_string.restype = ctypes.c_char_p
    lib.sgs_topq_scratch_words.argtypes = [ctypes.c_longlong]
    lib.sgs_topq_scratch_words.restype = ctypes.c_longlong
    return lib


def call(kernel: str, fn_name: str, device: torch.device, *args,
         route: str = "") -> None:
    """Launch ``fn_name`` on ``device``'s current stream, raise on a CUDA
    error, and count the launch under ``kernel`` (and ``route``, if any)."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.sgs_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1
    if route:
        ROUTES[kernel, route] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one card. They are called
    from inside ``autograd.Function``s (ops/scatter.py, edge_gather.py,
    spmm.py, score_sampled.py) or under ``no_grad`` (score_tiles.py), so autograd
    never records a kernel launch itself."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel got a {dev} tensor")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")

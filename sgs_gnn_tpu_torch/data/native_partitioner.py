"""ctypes bindings for the native C++ graph partitioner
(``native/partitioner.cpp``, the framework's METIS replacement).

The port never writes under ``native/``: at first use it compiles the
source with ``g++`` into ``build/native/`` at the repository root, named by
a hash of the source and the flags (as ``ops/_build.py`` names the kernels'
library), and loads that file. A failed build raises ``OSError``; the
caller (``data/partition.py``) then falls back to the scipy RCM
partitioner, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "partitioner.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    """Where the library of this source and these flags is (or will be)."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libpartitioner-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
    except FileNotFoundError as exc:          # no g++
        raise OSError(f"g++ not found: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed on {SRC}: {res.stderr[-2000:]}")
    os.replace(tmp, path)                     # concurrent builds: atomic


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.greedy_partition_ex.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, i32p]
    lib.greedy_partition_ex.restype = None
    lib.count_cut_edges.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
    lib.count_cut_edges.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def greedy_partition(edge_index: np.ndarray, num_nodes: int,
                     num_parts: int, deg_slack: float = 1.10,
                     node_slack: float = 1.35) -> np.ndarray:
    """Multilevel partition + refinement; returns int32[N] part ids.
    ``deg_slack`` / ``node_slack`` are the hard-cap multipliers over perfect
    balance (``greedy_partition_ex``; 1.10 is the JAX package's default,
    chosen by its sweep on the Reddit-scale workload)."""
    lib = _load()
    s = np.ascontiguousarray(edge_index[0], np.int32)
    r = np.ascontiguousarray(edge_index[1], np.int32)
    out = np.empty(num_nodes, np.int32)
    lib.greedy_partition_ex(_ptr(s), _ptr(r), np.int64(s.shape[0]),
                            np.int32(num_nodes), np.int32(num_parts),
                            float(deg_slack), float(node_slack), _ptr(out))
    return out


def cut_edges(edge_index: np.ndarray, part: np.ndarray) -> int:
    """Number of edges whose endpoints lie in different parts."""
    lib = _load()
    s = np.ascontiguousarray(edge_index[0], np.int32)
    r = np.ascontiguousarray(edge_index[1], np.int32)
    p = np.ascontiguousarray(part, np.int32)
    return int(lib.count_cut_edges(_ptr(s), _ptr(r), np.int64(s.shape[0]),
                                   _ptr(p)))

"""ctypes bindings for the C++ host runtime (legion_native.cpp).

Builds the shared library from src/legion_native.cpp on first use (g++;
C ABI + ctypes, no pybind11). The binary is a build output, never shipped:
it is compiled with -march=native for the host it runs on, and rebuilt
whenever the source is newer. Falls back to NumPy implementations when no
compiler is present, so the pure-Python path keeps working;
`build_error()` says why the build failed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "legion_native.cpp")
_LIB = os.path.join(_HERE, "liblegion_native.so")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> bool:
    """Compile into a private temp file, then rename into place: several
    processes (e.g. test workers) may build at once."""
    global _build_error
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
             "-fPIC", "-pthread", _SRC, "-o", tmp],
            check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, _LIB)
        return True
    except subprocess.CalledProcessError as e:
        _build_error = e.stderr[-2000:]
    except Exception as e:
        _build_error = repr(e)
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def build_error() -> Optional[str]:
    """Why the last build attempt failed (None if it did not fail)."""
    return _build_error


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.lg_gather_rows_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.lg_gather_rows_bf16.argtypes = lib.lg_gather_rows_f32.argtypes
    lib.lg_sample_neighbors.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int]
    lib.lg_edges_to_csr.restype = ctypes.c_int64
    lib.lg_edges_to_csr.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.lg_convert_edgelist.restype = ctypes.c_int
    lib.lg_convert_edgelist.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.lg_partition_ldg.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _nthreads() -> int:
    return max(1, os.cpu_count() or 1)


def gather_rows(features: np.ndarray, ids: np.ndarray,
                dtype: str = "float32") -> np.ndarray:
    """out[i] = features[ids[i]] (zeros for ids<0). Parallel C++ when
    available. dtype="bfloat16" converts in flight (halves the bytes the
    staged miss path ships host->device)."""
    ids = np.ascontiguousarray(ids, np.int32)
    lib = _load()
    if dtype == "bfloat16":
        import ml_dtypes
        out = np.empty((ids.shape[0], features.shape[1]),
                       ml_dtypes.bfloat16)
        if lib is None or not features.flags["C_CONTIGUOUS"]:
            mask = ids >= 0
            out[:] = 0
            out[mask] = features[ids[mask]].astype(ml_dtypes.bfloat16)
            return out
        lib.lg_gather_rows_bf16(
            features.ctypes.data_as(ctypes.c_void_p), features.shape[0],
            features.shape[1], ids.ctypes.data_as(ctypes.c_void_p),
            ids.shape[0], out.ctypes.data_as(ctypes.c_void_p), _nthreads())
        return out
    out = np.empty((ids.shape[0], features.shape[1]), np.float32)
    if lib is None or not features.flags["C_CONTIGUOUS"]:
        mask = ids >= 0
        out[:] = 0
        out[mask] = features[ids[mask]]
        return out
    lib.lg_gather_rows_f32(
        features.ctypes.data_as(ctypes.c_void_p), features.shape[0],
        features.shape[1], ids.ctypes.data_as(ctypes.c_void_p),
        ids.shape[0], out.ctypes.data_as(ctypes.c_void_p), _nthreads())
    return out


def sample_neighbors(indptr: np.ndarray, indices: np.ndarray,
                     frontier: np.ndarray, fanout: int,
                     seed: int) -> np.ndarray:
    """[n_frontier, fanout] uniform neighbor draws; -1 for invalid rows."""
    frontier = np.ascontiguousarray(frontier, np.int32)
    out = np.empty((frontier.shape[0], fanout), np.int32)
    lib = _load()
    if lib is None:
        rng = np.random.default_rng(seed)
        for i, v in enumerate(frontier):
            if v < 0:
                out[i] = -1
                continue
            lo, hi = indptr[v], indptr[v + 1]
            if hi <= lo:
                out[i] = -1
            else:
                out[i] = indices[rng.integers(lo, hi, size=fanout)]
        return out
    lib.lg_sample_neighbors(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p), indptr.shape[0] - 1,
        frontier.ctypes.data_as(ctypes.c_void_p), frontier.shape[0],
        fanout, seed & 0xFFFFFFFFFFFFFFFF,
        out.ctypes.data_as(ctypes.c_void_p), _nthreads())
    return out


def edges_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """(indptr int64, indices int32) from edge arrays; self-loops dropped."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    lib = _load()
    if lib is None:
        from legion_tpu.graph import CSRGraph
        g = CSRGraph.from_edges(src, dst, num_nodes)
        return g.indptr, g.indices
    indptr = np.zeros(num_nodes + 1, np.int64)
    indices = np.empty(src.shape[0], np.int32)
    kept = lib.lg_edges_to_csr(
        src.ctypes.data_as(ctypes.c_void_p),
        dst.ctypes.data_as(ctypes.c_void_p), src.shape[0], num_nodes,
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p))
    return indptr, indices[:kept].copy()


def partition_ldg(indptr: np.ndarray, indices: np.ndarray, n_parts: int,
                  passes: int = 2) -> np.ndarray:
    """Streaming LDG graph partitioning -> [V] int32 partition ids.
    Replaces the reference's external MPI XtraPuLP step
    (graph_partitioning.py:104-138)."""
    V = indptr.shape[0] - 1
    out = np.empty(V, np.int32)
    lib = _load()
    if lib is None:
        # NumPy fallback: plain hash partition (still valid, worse cut)
        out[:] = np.arange(V, dtype=np.int64) % n_parts
        return out
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    lib.lg_partition_ldg(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p), V, n_parts, passes,
        out.ctypes.data_as(ctypes.c_void_p))
    return out


def convert_edgelist(in_path: str, out_dir: str):
    """Text edge list -> Legion edge_src/edge_dst binaries (C++ fast path).
    Returns (num_nodes, num_edges)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable; "
                           "use the Python converter")
    os.makedirs(out_dir, exist_ok=True)
    n_nodes = ctypes.c_int64(0)
    n_edges = ctypes.c_int64(0)
    rc = lib.lg_convert_edgelist(
        in_path.encode(), out_dir.encode(), ctypes.byref(n_nodes),
        ctypes.byref(n_edges))
    if rc != 0:
        raise RuntimeError(f"convert_edgelist failed with code {rc}")
    return n_nodes.value, n_edges.value

"""ctypes bindings for the native host helpers, with auto-build and
pure-NumPy fallbacks.  See packer.cpp for what lives here and why."""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "packer.cpp")
_LIB = os.path.join(_DIR, "libsltnative.so")

_lib = None
_tried = False


def _build() -> bool:
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", _LIB]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # no toolchain / readonly fs -> fallback path
        print(f"[sublinear_tpu.native] build skipped: {e}", file=sys.stderr)
        return False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.coo_to_csr.restype = ctypes.c_int64
    lib.coo_to_csr.argtypes = [i64p, i64p, f64p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p]
    lib.greedy_coloring.restype = ctypes.c_int32
    lib.greedy_coloring.argtypes = [i64p, i32p, i64p, i32p, ctypes.c_int64, i32p]
    lib.dijkstra_multi_source.restype = None
    lib.dijkstra_multi_source.argtypes = [
        i64p, i32p, f64p, ctypes.c_int64, i64p, f64p, ctypes.c_int64, ctypes.c_double, f64p, f64p,
    ]
    lib.row_positions.restype = None
    lib.row_positions.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.rcm_ordering.restype = None
    lib.rcm_ordering.argtypes = [i64p, i32p, i64p, i32p, ctypes.c_int64, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def coo_to_csr(rows, cols, vals, n_rows):
    """Native triplet->CSR with dedup.  Returns (indptr, indices, data)."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    nnz = rows.size
    if lib is None:
        raise RuntimeError("native library unavailable")
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    indices = np.zeros(max(nnz, 1), dtype=np.int32)
    data = np.zeros(max(nnz, 1), dtype=np.float64)
    out_n = lib.coo_to_csr(rows, cols, vals, nnz, n_rows, indptr, indices, data)
    return indptr, indices[:out_n].copy(), data[:out_n].copy()


def greedy_coloring(indptr, indices, t_indptr, t_indices, n):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    colors = np.zeros(n, dtype=np.int32)
    lib.greedy_coloring(
        np.ascontiguousarray(indptr, np.int64), np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(t_indptr, np.int64), np.ascontiguousarray(t_indices, np.int32),
        n, colors,
    )
    return colors


def dijkstra_multi_source(indptr, indices, data, n, sources, source_vals, bound=1e30):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    dist = np.zeros(n, dtype=np.float64)
    srcval = np.zeros(n, dtype=np.float64)
    lib.dijkstra_multi_source(
        np.ascontiguousarray(indptr, np.int64), np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float64), n,
        np.ascontiguousarray(sources, np.int64), np.ascontiguousarray(source_vals, np.float64),
        len(np.atleast_1d(sources)), float(bound), dist, srcval,
    )
    return dist, srcval


def rcm_ordering(indptr, indices, t_indptr, t_indices, n):
    """Reverse Cuthill-McKee permutation (perm[new] = old) over the
    symmetrized pattern.  Native C++ with a pure-NumPy BFS fallback."""
    lib = get_lib()
    if lib is not None:
        perm = np.zeros(n, dtype=np.int64)
        lib.rcm_ordering(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32),
            np.ascontiguousarray(t_indptr, np.int64),
            np.ascontiguousarray(t_indices, np.int32),
            n, perm,
        )
        return perm
    # fallback: same algorithm in python
    indptr = np.asarray(indptr); indices = np.asarray(indices)
    t_indptr = np.asarray(t_indptr); t_indices = np.asarray(t_indices)
    degree = (indptr[1:] - indptr[:-1]) + (t_indptr[1:] - t_indptr[:-1])
    visited = np.zeros(n, dtype=bool)
    order = []
    for s in np.lexsort((np.arange(n), degree)):
        if visited[s]:
            continue
        visited[s] = True
        order.append(int(s))
        head = len(order) - 1
        while head < len(order):
            u = order[head]
            head += 1
            nbrs = np.concatenate([
                indices[indptr[u]:indptr[u + 1]],
                t_indices[t_indptr[u]:t_indptr[u + 1]],
            ])
            fresh = []
            for v in nbrs:
                v = int(v)
                if v != u and not visited[v]:
                    visited[v] = True
                    fresh.append(v)
            fresh.sort(key=lambda v: (degree[v], v))
            order.extend(fresh)
    return np.asarray(order[::-1], dtype=np.int64)

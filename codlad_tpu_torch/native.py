"""ctypes bindings of the port's host helpers (csrc/native_host.cpp).

Counterpart of codlad_tpu/native.py. The library is built with `g++ -O3
-shared -fPIC` at first use into codlad_tpu_torch/_build/ (git-ignored),
named by a hash of the source and the flags, and written under a temporary
name then renamed, so that processes building at once do not see a partial
file. Every entry point falls back to the JAX package's host versions when
the library cannot be built or loaded: scipy's LAP, the dense numpy radius
graph, and None from the XTC codec (data/xtc.py then runs its pure-Python
codec). `loaded()` says which is in use; the card's smoke run asserts it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "native_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
_error = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnative_host-{digest}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, out)


def load():
    """The ctypes library, built on first use; None where it cannot be
    built or loaded (the reason is kept: `load_error()`)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.lap_solve.restype = ctypes.c_int
            lib.lap_solve.argtypes = [_f64p, ctypes.c_int, _i32p]
            lib.radius_graph.restype = ctypes.c_int64
            lib.radius_graph.argtypes = [_f64p, _u8p, ctypes.c_int64, ctypes.c_double, _i32p,
                                         ctypes.c_int64]
            lib.xtc_decode.restype = ctypes.c_int
            lib.xtc_decode.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int32, _i32p, _i32p,
                                       ctypes.c_int32, ctypes.c_float, _f32p]
            lib.xtc_encode.restype = ctypes.c_int64
            lib.xtc_encode.argtypes = [_f32p, ctypes.c_int32, ctypes.c_float, _u8p,
                                       ctypes.c_int64, _i32p, _i32p, _i32p]
            _lib = lib
        except Exception as e:  # no g++, a failed build or load: the fallbacks run
            _lib, _error = None, f"{type(e).__name__}: {e}"
        return _lib


def loaded() -> bool:
    """True when the native library is in use (not the fallbacks)."""
    return load() is not None


def load_error():
    """Why the library did not load (None when it did or was not tried)."""
    load()
    return _error


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def lap_solve(cost):
    """Exact assignment: col_of_row [n] int32 minimising sum cost[i, col[i]]
    (float64 on the host)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"lap_solve takes a square cost matrix, not {cost.shape}")
    n = cost.shape[0]
    lib = load()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        if lib.lap_solve(_ptr(cost, _f64p), n, _ptr(out, _i32p)) == 0:
            return out
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)[1].astype(np.int32)


def radius_graph_dense(xyz, valid, cutoff):
    """The numpy O(N^2) form of `radius_graph`: undirected (i < j) pairs
    within cutoff among valid points, rows sorted."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    valid = np.asarray(valid).astype(bool)
    n = xyz.shape[0]
    pos = np.where(valid[:, None], xyz, 1e6 * (1.0 + np.arange(n, dtype=np.float64))[:, None])
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    ii, jj = np.where((d <= cutoff) & np.triu(np.ones((n, n), dtype=bool), k=1))
    return np.stack([ii, jj], axis=-1).astype(np.int32)


def radius_graph(xyz, valid, cutoff):
    """Undirected (i < j) pairs within cutoff among valid points, [E, 2]
    int32 with rows sorted: the native cell list, else the dense form."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = xyz.shape[0]
    if xyz.shape != (n, 3) or valid_u8.shape != (n,):
        raise ValueError(f"radius_graph takes xyz [n, 3] and valid [n], not {xyz.shape} "
                         f"and {valid_u8.shape}")
    lib = load()
    if lib is not None:
        cap = max(int(n) * 64, 1024)
        for _ in range(4):
            out = np.empty((cap, 2), dtype=np.int32)
            cnt = lib.radius_graph(_ptr(xyz, _f64p), _ptr(valid_u8, _u8p), n, float(cutoff),
                                   _ptr(out, _i32p), cap)
            if cnt <= cap:
                pairs = out[:cnt]
                return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
            cap = int(cnt) + 1024
    return radius_graph_dense(xyz, valid, cutoff)


def xtc_decode(data, natoms, minint, maxint, smallidx, precision):
    """Decode a 3dfcoord payload -> [natoms, 3] float32, or None without the
    library (the caller then decodes in Python)."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    mi = np.asarray(minint, dtype=np.int32)
    ma = np.asarray(maxint, dtype=np.int32)
    if mi.shape != (3,) or ma.shape != (3,):
        raise ValueError(f"xtc_decode takes 3 minint and 3 maxint, not {mi.shape}, {ma.shape}")
    out = np.empty((int(natoms), 3), dtype=np.float32)
    rc = lib.xtc_decode(_ptr(buf, _u8p), buf.size, int(natoms), _ptr(mi, _i32p),
                        _ptr(ma, _i32p), int(smallidx), float(precision), _ptr(out, _f32p))
    if rc != 0:
        raise ValueError(f"xtc_decode failed (rc={rc})")
    return out


def xtc_encode(xyz, precision):
    """Encode [N, 3] float32 -> (payload bytes, minint, maxint, smallidx),
    or None without the library."""
    lib = load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    if xyz.shape != (n, 3):
        raise ValueError(f"xtc_encode takes xyz [n, 3], not {xyz.shape}")
    cap = max(n * 16, 4096)
    mi, ma, si = np.empty(3, np.int32), np.empty(3, np.int32), np.empty(1, np.int32)
    out = np.empty(cap, np.uint8)
    nb = lib.xtc_encode(_ptr(xyz, _f32p), n, float(precision), _ptr(out, _u8p), cap,
                        _ptr(mi, _i32p), _ptr(ma, _i32p), _ptr(si, _i32p))
    if nb < 0:
        raise ValueError(f"xtc_encode failed (rc={nb})")
    return bytes(out[:nb]), mi.tolist(), ma.tolist(), int(si[0])

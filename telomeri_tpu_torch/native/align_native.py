"""ctypes loader for the native alignment helpers (align_native.cpp).

Optional like paf_native: every entry point returns None (or falls back) when
the library is missing or predates these symbols; utils/align.py then uses its
numpy/python implementations (same results — parity in tests/test_native.py).
Build with `python -m telomeri_tpu_torch.native.build`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from telomeri_tpu_torch.native.build import OUT as _LIB_PATH

_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tel_radix_argsort_kmers.restype = None
        lib.tel_radix_argsort_kmers.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        lib.tel_lis_chain.restype = ctypes.c_int64
        lib.tel_lis_chain.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.tel_myers_pair.restype = ctypes.c_int64
        lib.tel_myers_pair.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int]
        lib.tel_gap_trace.restype = ctypes.c_int64
        lib.tel_gap_trace.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except (OSError, AttributeError):   # missing lib or stale lib w/o symbols
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def radix_argsort_kmers(km: np.ndarray, bits: int):
    """(sorted_keys int64, positions int32) or None. km must be C-contiguous
    int64 with all keys in [0, 2^bits); callers pass bits = 2*k <= 62."""
    lib = _load()
    if lib is None or not (0 < bits <= 62):
        return None
    km = np.ascontiguousarray(km, np.int64)
    n = len(km)
    pos = np.empty(n, np.int32)
    out = np.empty(n, np.int64)
    lib.tel_radix_argsort_kmers(
        km.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, bits,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, pos


_MYERS_MODE = {"global": 0, "free_t_start": 1, "free_t_end": 2}


def myers_pair(q: np.ndarray, t: np.ndarray, mode: str):
    """Edit distance (int) or None. Exact port of align.myers_pair's loop;
    callers keep the m==0 / tn==0 early-outs."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.uint8)
    t = np.ascontiguousarray(t, np.uint8)
    return int(lib.tel_myers_pair(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        _MYERS_MODE[mode]))


def gap_trace(t: np.ndarray, q: np.ndarray):
    """(kinds int32, tpos int32, qpos int32) alignment ops, or None.

    Unit-cost global alignment with traceback — exact port of
    scaffold/polish.py _dp_trace (kind 0 = M, 1 = D, 2 = I; ties
    diagonal > up > left). The polish stage's inner loop: the python DP was
    87% of polish time at hg002-sub scale (~0.65 ms per ~50 bp gap)."""
    lib = _load()
    if lib is None:
        return None
    t = np.ascontiguousarray(t, np.uint8)
    q = np.ascontiguousarray(q, np.uint8)
    cap = len(t) + len(q)
    kinds = np.empty(max(cap, 1), np.int32)
    tpos = np.empty(max(cap, 1), np.int32)
    qpos = np.empty(max(cap, 1), np.int32)
    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n = lib.tel_gap_trace(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        as_i32(kinds), as_i32(tpos), as_i32(qpos))
    return kinds[:n], tpos[:n], qpos[:n]


def lis_chain(values: np.ndarray):
    """LIS indices (int64) or None. Byte-identical to align.lis_chain."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.int64)
    out = np.empty(len(v), np.int64)
    m = lib.tel_lis_chain(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(v),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:m].copy()

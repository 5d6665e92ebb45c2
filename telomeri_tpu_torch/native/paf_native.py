"""ctypes loader for the C++ PAF/FASTA fast parsers (telomeri_tpu_torch/native/*.cpp).

The native library is optional: `parse_paf_columns` returns None when it is unavailable and
callers fall back to the pure-Python parser (same semantics, tested for parity in
tests/test_native.py). Build with `python -m telomeri_tpu_torch.native.build`.
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
        lib.tel_parse_paf.restype = ctypes.c_void_p
        lib.tel_parse_paf.argtypes = [ctypes.c_char_p]
        lib.tel_paf_nrows.restype = ctypes.c_int64
        lib.tel_paf_nrows.argtypes = [ctypes.c_void_p]
        lib.tel_paf_error.restype = ctypes.c_char_p
        lib.tel_paf_error.argtypes = [ctypes.c_void_p]
        lib.tel_paf_fill.restype = None
        lib.tel_paf_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),  # ints (n, 9) row-major
            ctypes.POINTER(ctypes.c_int64),  # qname offsets (n+1)
            ctypes.POINTER(ctypes.c_int64),  # tname offsets (n+1)
        ]
        lib.tel_paf_names_bytes.restype = ctypes.c_int64
        lib.tel_paf_names_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tel_paf_copy_names.restype = None
        lib.tel_paf_copy_names.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_char)]
        lib.tel_paf_free.restype = None
        lib.tel_paf_free.argtypes = [ctypes.c_void_p]
        lib.tel_parse_fastx.restype = ctypes.c_void_p
        lib.tel_parse_fastx.argtypes = [ctypes.c_char_p]
        lib.tel_fastx_nseqs.restype = ctypes.c_int64
        lib.tel_fastx_nseqs.argtypes = [ctypes.c_void_p]
        lib.tel_fastx_error.restype = ctypes.c_char_p
        lib.tel_fastx_error.argtypes = [ctypes.c_void_p]
        lib.tel_fastx_names_bytes.restype = ctypes.c_int64
        lib.tel_fastx_names_bytes.argtypes = [ctypes.c_void_p]
        lib.tel_fastx_seqs_bytes.restype = ctypes.c_int64
        lib.tel_fastx_seqs_bytes.argtypes = [ctypes.c_void_p]
        lib.tel_fastx_fill.restype = None
        lib.tel_fastx_fill.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char),
            ctypes.POINTER(ctypes.c_int64)]
        for fn in ("tel_fastx_names_ptr", "tel_fastx_seqs_ptr",
                   "tel_fastx_name_off_ptr", "tel_fastx_seq_off_ptr"):
            getattr(lib, fn).restype = ctypes.c_void_p
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.tel_fastx_free.restype = None
        lib.tel_fastx_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def parse_paf_columns(path: str):
    """Parse a PAF file natively. Returns (qnames, tnames, ints[n,9]) or None if unavailable.

    ints columns: qlen qs qe strand tlen ts te nmatch blocklen (int64), matching
    telomeri_tpu_torch.io.paf._parse_columns_py.
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.tel_parse_paf(path.encode())
    if not h:
        raise OSError(f"native PAF parser: cannot open {path}")
    try:
        err = lib.tel_paf_error(h)
        if err:
            raise ValueError(err.decode())
        n = lib.tel_paf_nrows(h)
        ints = np.empty((n, 9), dtype=np.int64)
        qoff = np.empty(n + 1, dtype=np.int64)
        toff = np.empty(n + 1, dtype=np.int64)
        lib.tel_paf_fill(
            h,
            ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            toff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        names = []
        for which, off in ((0, qoff), (1, toff)):
            nbytes = lib.tel_paf_names_bytes(h, which)
            buf = ctypes.create_string_buffer(max(int(nbytes), 1))
            lib.tel_paf_copy_names(h, which, buf)
            # decode the whole blob ONCE, then slice strings — per-row bytes
            # slicing + .decode() was the hot spot on genome-scale PAFs. Byte
            # offsets equal char offsets only while the blob is pure ASCII
            # (true for real PAFs); otherwise fall back to per-row decoding.
            blob = buf.raw[:nbytes]
            s = blob.decode()
            o = off.tolist()
            if len(s) == nbytes:
                names.append(np.array(
                    [s[o[i]:o[i + 1]] for i in range(n)], dtype=object))
            else:
                names.append(np.array(
                    [blob[o[i]:o[i + 1]].decode() for i in range(n)], dtype=object))
        return names[0], names[1], ints
    finally:
        lib.tel_paf_free(h)


def _wrap_buffer(ptr: int, nbytes: int, dtype, owner) -> np.ndarray:
    """Numpy view over foreign memory; `owner` kept alive via the .base chain."""
    if nbytes == 0:
        return np.empty(0, dtype=dtype)
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    buf._owner = owner  # noqa: SLF001 — keep the finalizing owner alive
    return np.frombuffer(buf, dtype=dtype)


class _FastxHandle:
    """Owns the C++ FastxFile; frees it when the last numpy view dies."""

    def __init__(self, lib, h):
        self._lib = lib
        self._h = h

    def __del__(self):
        if self._h:
            self._lib.tel_fastx_free(self._h)
            self._h = None


def parse_fastx(path: str):
    """Parse FASTA/FASTQ natively. Returns (names: list[str], seqs: list[np.uint8
    arrays]) or None if the library is unavailable. Sequence arrays are ZERO-COPY
    views into the parser's buffer (freed when the views are garbage-collected) —
    this host's RAM copies are slow (~50 MB/s measured), so avoiding the memcpy is
    a 3x end-to-end win on genome-scale files."""
    lib = _load()
    if lib is None:
        return None
    h = lib.tel_parse_fastx(path.encode())
    if not h:
        raise OSError(f"native FASTX parser: cannot open {path}")
    err = lib.tel_fastx_error(h)
    if err:
        msg = err.decode()
        lib.tel_fastx_free(h)
        raise ValueError(msg)
    owner = _FastxHandle(lib, h)
    n = lib.tel_fastx_nseqs(h)
    nb = int(lib.tel_fastx_names_bytes(h))
    sb = int(lib.tel_fastx_seqs_bytes(h))
    name_off = np.array(_wrap_buffer(
        lib.tel_fastx_name_off_ptr(h), 8 * (n + 1), np.int64, owner))
    seq_off = np.array(_wrap_buffer(
        lib.tel_fastx_seq_off_ptr(h), 8 * (n + 1), np.int64, owner))
    names_blob = bytes(_wrap_buffer(lib.tel_fastx_names_ptr(h), nb, np.uint8, owner))
    seq_arr = _wrap_buffer(lib.tel_fastx_seqs_ptr(h), sb, np.uint8, owner)
    names = [names_blob[name_off[i]:name_off[i + 1]].decode() for i in range(n)]
    seqs = [seq_arr[seq_off[i]:seq_off[i + 1]] for i in range(n)]
    return names, seqs

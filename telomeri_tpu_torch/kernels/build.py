"""Build the port's CUDA kernels and load them with ctypes.

Every `csrc/*.cu` source is compiled by nvcc for Hopper (`sm_90a`) into ONE
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes). The library lands in `build/telomeri_tpu_torch/` at the
repository root, named by a hash of the flags and of every `csrc/*.cu` and
`csrc/*.cuh` file (the headers the sources include): the first call after
a checkout or an edit builds it, later calls reuse it. Wrappers pass raw device
pointers (`tensor.data_ptr()`) and PyTorch's current stream; each C function
returns `cudaGetLastError()` and the wrapper raises when it is not 0.

Nothing here runs at import time: the CPU tests import every module on machines
with no CUDA toolkit.

    python -m telomeri_tpu_torch.kernels.build    # build now, print the path
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG), "build", "telomeri_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    # scoring must round every float op separately (csrc/scoring.cu)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: ctypes.CDLL | None = None
# what the last build printed (ptxas registers / spills per kernel), for reports
build_log = ""
build_seconds = 0.0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _hashed() -> list[str]:
    """The files the library is built from: the sources and their headers."""
    return sorted(_sources() + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtelomeri_kernels_{h.hexdigest()[:16]}.so")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME): the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the hashed library unless it already exists."""
    global build_log, build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.telomeri_score_overlaps.argtypes = [p] * 12 + [ll, i, p]
    lib.telomeri_score_overlaps.restype = i
    lib.telomeri_walk_scan.argtypes = [p, p, i, p, p, ctypes.c_uint, i, i, p, p]
    lib.telomeri_walk_scan.restype = i
    lib.telomeri_resolve_events.argtypes = [p] * 7 + [i, i, i] + [p] * 8
    lib.telomeri_resolve_events.restype = i
    lib.telomeri_greedy_scan.argtypes = [p, i, ll] + [p] * 5 + [ctypes.c_uint, i, i, i, i] + [p] * 8
    lib.telomeri_greedy_scan.restype = i
    lib.telomeri_chase.argtypes = [p, i, i, p, p]
    lib.telomeri_chase.restype = i
    lib.telomeri_error_string.argtypes = [i]
    lib.telomeri_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if rc != 0:
        msg = load().telomeri_error_string(rc).decode()
        raise RuntimeError(f"{what}: launch failed with CUDA error {rc} ({msg})")


if __name__ == "__main__":
    print(build(verbose=True))
    print(build_log)

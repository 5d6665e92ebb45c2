"""Build the native C++ helpers: `python -m telomeri_tpu_torch.native.build`.

Produces build/telomeri_tpu_torch/libtelomeri_native.so at the repository root
(beside the CUDA kernels' library; loaded lazily via ctypes by paf_native.py and
align_native.py; everything degrades to the pure-Python parsers when absent).
These are host parsers, compiled by g++: no CUDA toolkit is needed."""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ["paf_parser.cpp", "align_native.cpp"]
OUT = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                   "telomeri_tpu_torch", "libtelomeri_native.so")


def build(verbose: bool = True) -> str:
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    tmp = f"{OUT}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        *[os.path.join(HERE, s) for s in SOURCES],
        "-o", tmp,
    ]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    subprocess.run(cmd, check=True)
    os.replace(tmp, OUT)   # atomic: a concurrent loader never sees half a file
    return OUT


if __name__ == "__main__":
    build()
    print(OUT)

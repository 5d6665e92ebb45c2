"""Overlap-extension scoring SI / OS / ES: the port of telomeri_tpu/kernels/scoring.py.

Formulas (ScaffoldConfig docstring has the geometry), all float32, in exactly
this order — every implementation below is bit-equal to the numpy oracle:
  SI  = nmatch / max(blocklen, 1)
  OS  = SI * ((OL1 + OL2) * 0.5)
  pen = (OH1 + OH2) * 0.5
  ES1 = OS + EL1 * 0.5 - pen
  ES2 = OS + EL2 * 0.5 - pen

  - score_arrays_np       numpy oracle (host graph build, tests)
  - score_overlaps_torch  plain torch version: CPU tensors, and the comparison
                          for the kernel on the card
  - score_overlaps_cuda   the hand-written kernel (csrc/scoring.cu), 4 outputs
                          (SI, OS, ES1, ES2) or 2 (OS, ES2: the rescore path)
  - score_overlaps        dispatch on the tensors' device

The kernel replaces the Pallas TPU kernels _score_kernel (4 outputs) and
_score_kernel_os_es2 (2 outputs) of telomeri_tpu/kernels/scoring.py. It is bound
by device memory bandwidth: 48 B a row with 4 outputs, 36 B with 2 (el1 is then
not read). On arrays that are all 16-byte aligned (whole tensors of PyTorch's
allocator) each thread takes four rows with 16-byte loads and stores; a view
that starts off that alignment (a[1:]) takes the kernel's 4-byte instantiation,
chosen by the C launcher. At the rescore path's size the pass takes microseconds on the card,
so the wrapper keeps its own cost on the host small: the library function is
resolved once, the outputs are rows of one allocation (each row starting on
16 bytes), and the geometry is checked in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from telomeri_tpu_torch.kernels import build
from telomeri_tpu_torch.utils.profiling import count, profiler_running, span


def score_arrays_np(nm, bl, ol1, ol2, oh1, oh2, el1, el2):
    """Numpy float32 oracle. Returns (si, os, es1, es2)."""
    f = lambda a: np.asarray(a).astype(np.float32)
    si = f(nm) / np.maximum(f(bl), np.float32(1.0))
    os_ = si * ((f(ol1) + f(ol2)) * np.float32(0.5))
    pen = (f(oh1) + f(oh2)) * np.float32(0.5)
    es1 = os_ + f(el1) * np.float32(0.5) - pen
    es2 = os_ + f(el2) * np.float32(0.5) - pen
    return si, os_, es1, es2


def score_overlaps_torch(nm, bl, ol1, ol2, oh1, oh2, el1, el2, *, outputs: int = 4):
    """Plain torch version on any device: (si, os, es1, es2), or (os, es2) when
    outputs == 2. Each op is its own rounding step (no fusion in eager mode)."""
    f = lambda a: a.to(torch.float32)
    si = f(nm) / torch.clamp_min(f(bl), 1.0)
    os_ = si * ((f(ol1) + f(ol2)) * 0.5)
    pen = (f(oh1) + f(oh2)) * 0.5
    es2 = os_ + f(el2) * 0.5 - pen
    if outputs == 2:
        return os_, es2
    es1 = os_ + f(el1) * 0.5 - pen
    return si, os_, es1, es2


def _check_geom(geom) -> int:
    if len(geom) != 8:
        raise ValueError(f"scoring takes 8 geometry arrays, got {len(geom)}")
    first = geom[0]
    shape, dev = first.shape, first.device
    if len(shape) != 1:
        raise ValueError(f"geometry arrays must be 1-D of one length, got {tuple(shape)}")
    for a in geom:
        if a.shape != shape:
            raise ValueError(f"geometry arrays must be 1-D of one length, got {tuple(a.shape)}")
        if a.dtype != torch.int32 or not a.is_contiguous() or a.device != dev:
            raise ValueError("geometry arrays must be contiguous int32 on one device")
    return shape[0]


def _output_rows(n: int, outputs: int, device) -> tuple:
    """`outputs` float32 (n,) tensors, the rows of one allocation, each row
    starting on a 16-byte boundary (the row stride is n rounded up to 4)."""
    stride = (n + 3) & ~3
    rows = torch.empty((outputs, stride), dtype=torch.float32, device=device).unbind(0)
    return rows if stride == n else tuple(r[:n] for r in rows)


_kernel = None   # the library's telomeri_score_overlaps, resolved at the first launch


def score_overlaps_cuda(nm, bl, ol1, ol2, oh1, oh2, el1, el2, *, outputs: int = 4):
    """The CUDA kernel on contiguous int32 CUDA tensors. Launches on the current
    stream, raises if the launch fails; returns what score_overlaps_torch does."""
    geom = (nm, bl, ol1, ol2, oh1, oh2, el1, el2)
    if not profiler_running():
        return _score_overlaps_cuda(geom, outputs)
    with span("kernel.score"):
        return _score_overlaps_cuda(geom, outputs)


def _score_overlaps_cuda(geom: tuple, outputs: int) -> tuple:
    global _kernel
    nm, bl, ol1, ol2, oh1, oh2, el1, el2 = geom
    n = _check_geom(geom)
    dev = nm.device
    if dev.type != "cuda":
        raise ValueError("score_overlaps_cuda needs CUDA tensors")
    if outputs not in (2, 4):
        raise ValueError(f"outputs must be 2 or 4, got {outputs}")
    if dev.index != torch.cuda.current_device():   # the launch goes to the current device
        with torch.cuda.device(dev):
            return _score_overlaps_cuda(geom, outputs)
    if _kernel is None:
        _kernel = build.load().telomeri_score_overlaps
    out = _output_rows(n, outputs, dev)
    si, os_, es1, es2 = ([o.data_ptr() for o in out] if outputs == 4
                         else (None, out[0].data_ptr(), None, out[1].data_ptr()))
    rc = _kernel(nm.data_ptr(), bl.data_ptr(), ol1.data_ptr(), ol2.data_ptr(),
                 oh1.data_ptr(), oh2.data_ptr(), el1.data_ptr(), el2.data_ptr(),
                 si, os_, es1, es2, n, outputs, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        build.check(rc, "score_overlaps")
    count("launch." + ("score_overlaps" if outputs == 4 else "score_os_es2"))
    return out


def score_overlaps(nm, bl, ol1, ol2, oh1, oh2, el1, el2, *, outputs: int = 4):
    """Dispatch on where the tensors lie: the plain version for CPU tensors, the
    kernel for CUDA tensors (it raises rather than fall back)."""
    geom = (nm, bl, ol1, ol2, oh1, oh2, el1, el2)
    kind = nm.device.type
    if kind == "cuda":
        return score_overlaps_cuda(*geom, outputs=outputs)
    _check_geom(geom)
    if kind == "cpu":
        return score_overlaps_torch(*geom, outputs=outputs)
    raise ValueError(f"no scoring path for device {nm.device}")

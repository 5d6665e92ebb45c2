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
by device memory bandwidth: 32 B read and 8 or 16 B written per row.
"""

from __future__ import annotations

import numpy as np
import torch

from telomeri_tpu_torch.kernels import build

# launches of the kernel, by variant; only the wrappers below add to them
launches = {"score_os_es2": 0, "score_overlaps": 0}


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
    n = geom[0].shape[0]
    dev = geom[0].device
    for a in geom:
        if a.dim() != 1 or a.shape[0] != n:
            raise ValueError(f"geometry arrays must be 1-D of one length, got {tuple(a.shape)}")
        if a.dtype != torch.int32 or not a.is_contiguous() or a.device != dev:
            raise ValueError("geometry arrays must be contiguous int32 on one device")
    return n


def score_overlaps_cuda(nm, bl, ol1, ol2, oh1, oh2, el1, el2, *, outputs: int = 4):
    """The CUDA kernel on contiguous int32 CUDA tensors. Launches on the current
    stream, raises if the launch fails; returns what score_overlaps_torch does."""
    geom = (nm, bl, ol1, ol2, oh1, oh2, el1, el2)
    n = _check_geom(geom)
    if geom[0].device.type != "cuda":
        raise ValueError("score_overlaps_cuda needs CUDA tensors")
    if outputs not in (2, 4):
        raise ValueError(f"outputs must be 2 or 4, got {outputs}")
    lib = build.load()
    with torch.cuda.device(geom[0].device):
        out = [torch.empty(n, dtype=torch.float32, device=geom[0].device)
               for _ in range(outputs)]
        si, os_, es1, es2 = out if outputs == 4 else (None, out[0], None, out[1])
        ptr = lambda t: t.data_ptr() if t is not None else None
        rc = lib.telomeri_score_overlaps(
            *[a.data_ptr() for a in geom], ptr(si), ptr(os_), ptr(es1), ptr(es2),
            n, outputs, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "score_overlaps")
    launches["score_overlaps" if outputs == 4 else "score_os_es2"] += 1
    return tuple(out)


def score_overlaps(nm, bl, ol1, ol2, oh1, oh2, el1, el2, *, outputs: int = 4):
    """Dispatch on where the tensors lie: the plain version for CPU tensors, the
    kernel for CUDA tensors (it raises rather than fall back)."""
    geom = (nm, bl, ol1, ol2, oh1, oh2, el1, el2)
    _check_geom(geom)
    kind = geom[0].device.type
    if kind == "cpu":
        return score_overlaps_torch(*geom, outputs=outputs)
    if kind == "cuda":
        return score_overlaps_cuda(*geom, outputs=outputs)
    raise ValueError(f"no scoring path for device {geom[0].device}")

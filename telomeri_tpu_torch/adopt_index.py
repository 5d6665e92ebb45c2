"""Adopt pre-existing k-mer index arrays into the resumable validate cache: the
port of tools/adopt_index.py.

An index build that wrote `sorted_km` / `sorted_pos` (the long sort) but died
before their fingerprints leaves `utils.validate._cached_index` with a miss, and
it would redo the whole build. This tool verifies such orphaned arrays against
the genome they claim to index and, if they check out, stamps the per-part
fingerprints the cache expects.

Verification (no re-pack needed):
  * shapes: len(sorted_km) == len(sorted_pos) == len(genome) - k + 1
  * order:  sorted_km is non-decreasing on a dense sample
  * content: for N random ranks i, the k-mer packed directly from
    genome[sorted_pos[i]:+k] equals sorted_km[i]

Usage: python -m telomeri_tpu_torch.adopt_index GENOME.fa CACHE_STEM [--k 24] [--samples N]
  CACHE_STEM e.g. /data/run/genome.k24.idx
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib

import numpy as np

from telomeri_tpu_torch.io.fasta import read_fasta
from telomeri_tpu_torch.utils.align import _CODE_LUT


def kmers_at(arr: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    """Pack the k-mers starting at each position (k gathers of len(pos))."""
    km = np.zeros(len(pos), np.int64)
    for i in range(k):
        km = (km << 2) | _CODE_LUT[arr[pos + i]]
    return km


def adopt(genome_path: str, stem: str, k: int, samples: int) -> int:
    gs = read_fasta(genome_path, lazy="auto")
    if len(gs.names) != 1:
        print(f"expected exactly one reference sequence, got {len(gs.names)}")
        return 1
    arr = np.asarray(gs.seqs[0])
    n = len(arr) - k + 1
    km = np.load(f"{stem}.sorted_km.npy", mmap_mode="r")
    pos = np.load(f"{stem}.sorted_pos.npy", mmap_mode="r")
    if len(km) != n or len(pos) != n:
        print(f"shape mismatch: index {len(km)}/{len(pos)} vs genome kmers {n}")
        return 1
    rng = np.random.default_rng(0)
    idx = np.sort(rng.integers(0, n - 1, samples))
    if not np.all(np.asarray(km[idx]) <= np.asarray(km[idx + 1])):
        print("sorted_km is not sorted on sample")
        return 1
    p = np.asarray(pos[idx]).astype(np.int64)
    if p.min() < 0 or p.max() >= n:
        print("sorted_pos out of range")
        return 1
    want = kmers_at(arr, p, k)
    got = np.asarray(km[idx])
    bad = int((want != got).sum())
    if bad:
        print(f"{bad}/{samples} sampled k-mers mismatch — refusing to adopt")
        return 1
    crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)))
    fp = np.array([k, len(arr), crc], np.int64)
    for part in ("sorted_km", "sorted_pos"):
        np.save(f"{stem}.{part}.fp.tmp.npy", fp)
        os.replace(f"{stem}.{part}.fp.tmp.npy", f"{stem}.{part}.fp.npy")
    # clean any stray tmp from the interrupted build
    for f in os.listdir(os.path.dirname(stem) or "."):
        if f.startswith(os.path.basename(stem)) and ".tmp.npy" in f:
            os.remove(os.path.join(os.path.dirname(stem) or ".", f))
    print(f"adopted {stem}: {samples} sampled k-mers verified, fp = {fp.tolist()}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m telomeri_tpu_torch.adopt_index")
    ap.add_argument("genome")
    ap.add_argument("stem")
    ap.add_argument("--k", type=int, default=24)
    ap.add_argument("--samples", type=int, default=1_000_000)
    a = ap.parse_args(argv)
    return adopt(a.genome, a.stem, a.k, a.samples)


if __name__ == "__main__":
    sys.exit(main())

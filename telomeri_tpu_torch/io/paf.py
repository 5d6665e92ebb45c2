"""PAF (minimap2 Pairwise mApping Format) parsing into structure-of-arrays.

Reference parity: the C++ reference's PAFOverlap ingest (SURVEY.md §3 row 3; mount empty,
SURVEY.md §0). Columns used (1-based PAF): 1 qname, 2 qlen, 3 qstart, 4 qend, 5 strand,
6 tname, 7 tlen, 8 tstart, 9 tend, 10 nmatch, 11 blocklen. Extra columns are ignored.

Output is SoA numpy (int32 coordinates, int32 ids) — the tensor-facing format fixed by the
north star (SURVEY.md §1: "PAF overlaps → padded SoA tensors"). Name→id resolution happens
here so everything downstream is integer-only.

A C++ mmap parser (telomeri_tpu_torch/native/paf_parser.cpp) is used automatically for speed when
its shared library is built; this pure-Python path defines the semantics and is the fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PafRecords:
    """Parsed PAF rows as SoA. All arrays share length n_rows.

    qid/tid index into the global sequence table handed to `parse_paf`.
    strand: 0 for '+', 1 for '-'.
    """

    qid: np.ndarray      # int32
    qlen: np.ndarray     # int32
    qstart: np.ndarray   # int32
    qend: np.ndarray     # int32
    strand: np.ndarray   # int8
    tid: np.ndarray      # int32
    tlen: np.ndarray     # int32
    tstart: np.ndarray   # int32
    tend: np.ndarray     # int32
    nmatch: np.ndarray   # int32
    blocklen: np.ndarray  # int32

    def __len__(self) -> int:
        return len(self.qid)

    @staticmethod
    def concatenate(parts: list["PafRecords"]) -> "PafRecords":
        return PafRecords(*[
            np.concatenate([getattr(p, f) for p in parts])
            for f in ("qid", "qlen", "qstart", "qend", "strand",
                      "tid", "tlen", "tstart", "tend", "nmatch", "blocklen")
        ])


def parse_paf(path: str, name_index: dict[str, int], strict: bool = True) -> PafRecords:
    """Parse a PAF file, resolving sequence names through `name_index`.

    Rows naming sequences absent from `name_index` raise (strict=True) or are dropped
    (strict=False, counted). Deterministic: rows keep file order.
    """
    from telomeri_tpu_torch.io.fasta import _read_bytes
    from telomeri_tpu_torch.native import paf_native

    with open(path, "rb") as f:
        gzipped = f.read(2) == b"\x1f\x8b"
    if gzipped:
        # decompress to memory and use the Python splitter (the native parser reads
        # from the filesystem; gz PAFs are small enough that this path is fine)
        qnames, tnames, ints = _parse_columns_bytes(_read_bytes(path), path)
    else:
        raw = paf_native.parse_paf_columns(path)
        if raw is not None:
            qnames, tnames, ints = raw
        else:
            qnames, tnames, ints = _parse_columns_py(path)

    qid = _resolve(qnames, name_index)
    tid = _resolve(tnames, name_index)
    keep = (qid >= 0) & (tid >= 0)
    if strict and not keep.all():
        bad = int((~keep).sum())
        i = int(np.flatnonzero(~keep)[0])
        name = qnames[i] if qid[i] < 0 else tnames[i]  # name the actual offender
        raise KeyError(f"{path}: {bad} PAF rows name unknown sequences (e.g. {name!r})")
    if not keep.all():
        ints = ints[keep]
        qid, tid = qid[keep], tid[keep]

    i32 = lambda c: ints[:, c].astype(np.int32)
    return PafRecords(
        qid=qid.astype(np.int32), qlen=i32(0), qstart=i32(1), qend=i32(2),
        strand=ints[:, 3].astype(np.int8),
        tid=tid.astype(np.int32), tlen=i32(4), tstart=i32(5), tend=i32(6),
        nmatch=i32(7), blocklen=i32(8),
    )


def _parse_columns_py(path: str):
    """Pure-Python column splitter: (qnames, tnames, int matrix [qlen qs qe strand tlen ts te nm bl])."""
    with open(path, "rb") as f:
        return _parse_columns_bytes(f.read(), path)


def _parse_columns_bytes(data: bytes, path: str):
    qnames: list[str] = []
    tnames: list[str] = []
    rows: list[tuple[int, ...]] = []
    for lineno, line in enumerate(data.split(b"\n"), 1):
        line = line.rstrip(b"\r")
        if not line:
            continue
        cols = line.split(b"\t")
        if len(cols) < 11:
            raise ValueError(f"{path}:{lineno}: PAF row has {len(cols)} < 11 columns")
        if cols[4] not in (b"+", b"-"):
            raise ValueError(f"{path}:{lineno}: bad strand {cols[4]!r}")
        qnames.append(cols[0].decode())
        tnames.append(cols[5].decode())
        rows.append((int(cols[1]), int(cols[2]), int(cols[3]),
                     0 if cols[4] == b"+" else 1,
                     int(cols[6]), int(cols[7]), int(cols[8]),
                     int(cols[9]), int(cols[10])))
    ints = np.array(rows, dtype=np.int64).reshape(len(rows), 9)
    return np.array(qnames, dtype=object), np.array(tnames, dtype=object), ints


def _resolve(names: np.ndarray, name_index: dict[str, int]) -> np.ndarray:
    out = np.empty(len(names), dtype=np.int64)
    for i, n in enumerate(names):
        out[i] = name_index.get(n, -1)
    return out

"""FASTA/FASTQ reading and FASTA writing (host side).

Reference parity: the C++ reference's SequenceLoader (SURVEY.md §3 rows 2, 14; the mount was
empty this round, so no file:line citation is possible — provenance in SURVEY.md §0).

Design (SURVEY.md §2.2): sequences stay host-side as numpy uint8 byte arrays for the
stitcher; only lengths and the id table ever go to the device. A C++ fast path
(telomeri_tpu_torch/native) mmap-parses large files; this module is the portable fallback and
the single source of truth for semantics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtNnUuRYKMrykm", b"TGCATGCANNAAYRMKyrmk"):
    _COMP[_a] = _b
# anything unmapped complements to 'N'
for _i in range(256):
    if _COMP[_i] == 0:
        _COMP[_i] = ord("N")


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    """Reverse-complement a uint8 sequence array."""
    return _COMP[seq[::-1]]


def _build_index(names: list[str]) -> dict[str, int]:
    """name -> position; raises on duplicates (shared by eager + lazy sets)."""
    index = {n: i for i, n in enumerate(names)}
    if len(index) != len(names):
        seen: set[str] = set()
        dupes = []
        for n in names:
            if n in seen:
                dupes.append(n)
            seen.add(n)
        raise ValueError(f"duplicate sequence names: {dupes[:5]}")
    return index


@dataclass
class SequenceSet:
    """A set of named sequences as numpy byte arrays.

    names:   list of sequence ids (first whitespace-delimited token of the header)
    seqs:    list of np.uint8 arrays (ASCII bytes, case preserved)
    lengths: int64 array of sequence lengths
    index:   name -> position
    """

    names: list[str]
    seqs: list[np.ndarray]

    def __post_init__(self) -> None:
        self.lengths = np.array([len(s) for s in self.seqs], dtype=np.int64)
        self.index = _build_index(self.names)

    def __len__(self) -> int:
        return len(self.names)


class _LazySeqs:
    """List-like lazy sequence accessor over an mmap'd file.

    Each __getitem__ materializes ONE sequence: a zero-copy mmap view when the
    record's bytes are contiguous (single-line FASTA/FASTQ — the common case for
    long-read data), else a newline-stripped copy (multi-line FASTA). Nothing else
    is resident, so a whole-genome read set costs index memory only
    (docs/ARCHITECTURE.md "Memory budget at HG002 scale": the ~65 GB host-RAM
    sequence store was the real constraint; stitching touches only the reads on
    bridged paths)."""

    def __init__(self, buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 lengths: np.ndarray, mm) -> None:
        self._buf = buf          # uint8 view of the mmap
        self._starts = starts    # (n,) span start (first sequence byte)
        self._ends = ends        # (n,) span end (exclusive, may include newlines)
        self._lengths = lengths  # (n,) sequence length (newlines excluded)
        self._mm = mm            # keep the mmap (and file) alive

    def __len__(self) -> int:
        return len(self._starts)

    def __getitem__(self, i: int) -> np.ndarray:
        s, e, n = self._starts[i], self._ends[i], self._lengths[i]
        span = self._buf[s:e]
        if e - s == n:
            return span                       # zero-copy view
        if e - s == n + 1 and span[-1] == 10:
            return span[:-1]                  # zero-copy view (trailing newline)
        return span[span != 10]               # multi-line: strip newlines (copy)


class LazySequenceSet:
    """SequenceSet-shaped lazy set (same attributes: names/seqs/lengths/index)."""

    def __init__(self, names: list[str], seqs: _LazySeqs, lengths: np.ndarray) -> None:
        self.names = names
        self.seqs = seqs
        self.lengths = lengths
        self.index = _build_index(names)

    def __len__(self) -> int:
        return len(self.names)


def _index_lazy(mm):
    """Index pass over an mmap: returns (names, starts, ends, lengths) or None
    when the layout needs the eager parser (CRLF, blank lines, non-4-line FASTQ).

    All numpy views of `mm` are locals of THIS function, so when it returns None
    the caller can mm.close() without BufferError (no exported buffers remain)."""
    buf = np.frombuffer(mm, dtype=np.uint8)
    # chunked scan: newline offsets + CR detection in bounded windows, so peak
    # host memory during indexing is ~one chunk of temporaries plus the index —
    # NOT file-sized boolean arrays (the whole point of the lazy store)
    _CHUNK = 64 << 20
    nl_parts: list[np.ndarray] = []
    for off in range(0, len(buf), _CHUNK):
        win = buf[off:off + _CHUNK]
        if (win == 13).any():                 # CRLF: eager parser handles it
            return None
        nl_parts.append(np.flatnonzero(win == 10).astype(np.int64) + off)
    nl = (np.concatenate(nl_parts) if nl_parts else np.empty(0, np.int64))
    ends_with_nl = len(nl) > 0 and nl[-1] == len(buf) - 1
    line_ends = nl if ends_with_nl else np.append(nl, len(buf))
    line_starts = np.concatenate([[np.int64(0)], line_ends[:-1] + 1])
    if (line_starts == line_ends).any():      # blank lines: eager parser
        return None
    first = buf[line_starts]
    names: list[str]
    if buf[0] == ord(">"):
        hdr = np.flatnonzero(first == ord(">"))
        names = [
            _header_name(bytes(buf[line_starts[h]:line_ends[h]]), "FASTA")
            for h in hdr]
        # sequence span of record i: from the line after its header to the start
        # of the next header line (or EOF)
        starts = line_ends[hdr] + 1
        rec_end_line = np.append(hdr[1:], len(line_starts))
        ends = np.where(rec_end_line < len(line_starts),
                        line_starts[np.minimum(rec_end_line, len(line_starts) - 1)],
                        np.int64(len(buf)))
        # newline count inside each span via positions of newlines
        n_nl = np.searchsorted(nl, ends) - np.searchsorted(nl, starts)
        lengths = (ends - starts) - n_nl
        if (lengths < 0).any() or (starts > ends).any():
            return None
    else:  # FASTQ ('@' guaranteed by _read_lazy's first-byte check)
        if len(line_starts) % 4 != 0:
            return None                       # not strict 4-line FASTQ
        hdr = np.arange(0, len(line_starts), 4)
        if not (first[hdr] == ord("@")).all() or not (first[hdr + 2] == ord("+")).all():
            return None
        names = [
            _header_name(bytes(buf[line_starts[h]:line_ends[h]]), "FASTQ")
            for h in hdr]
        starts = line_starts[hdr + 1]
        ends = line_ends[hdr + 1]
        lengths = ends - starts
    return names, starts, ends, lengths.astype(np.int64)


def _read_lazy(path: str):
    """mmap-index a plain (non-gz) FASTA/FASTQ without materializing sequences.

    Returns a LazySequenceSet, or None when the file needs the eager parser
    (CRLF line endings, blank interior lines, or FASTQ not in strict 4-line
    records — all rare; correctness falls back, never degrades)."""
    import mmap

    with open(path, "rb") as f:
        try:
            if os.fstat(f.fileno()).st_size == 0:
                empty = np.empty(0, np.int64)
                return LazySequenceSet(
                    [], _LazySeqs(np.empty(0, np.uint8), empty, empty, empty, None),
                    empty)
            # the mmap dups the fd; the file object can close immediately
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            return None
    b0 = mm[0:1]                              # plain bytes — no exported view
    if b0 not in (b">", b"@"):
        mm.close()
        raise ValueError(f"{path}: not FASTA/FASTQ (first byte {b0!r})")
    res = _index_lazy(mm)
    if res is None:
        mm.close()                            # safe: _index_lazy's views are gone
        return None
    names, starts, ends, lengths = res
    buf = np.frombuffer(mm, dtype=np.uint8)
    return LazySequenceSet(
        names, _LazySeqs(buf, starts, ends, lengths, mm), lengths)


def _read_bytes(path: str) -> bytes:
    """Read a file, transparently decompressing gzip (magic-byte detection)."""
    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\x1f\x8b":
            import gzip

            f.seek(0)
            with gzip.open(f) as gz:
                return gz.read()
        return head + f.read()


_LAZY_AUTO_BYTES = 1 << 30  # "auto" goes lazy at >= 1 GiB (whole-genome read sets)


def read_fasta(path: str, lazy: str = "off") -> SequenceSet | LazySequenceSet:
    """Read FASTA or FASTQ, plain or .gz (both auto-detected). Multi-line FASTA ok.

    lazy="on"/"auto"/"off" (ScaffoldConfig.lazy_sequences): "on" mmap-indexes the
    file and materializes sequences one at a time on access (host-RAM fix for
    whole-genome read sets — docs/ARCHITECTURE.md memory budget); "auto" does so
    for plain files >= 1 GiB. Results are element-identical to the eager parser
    (parity-tested); gzip/CRLF/irregular layouts silently fall back to eager.

    Plain files use the C++ fast parser when built (parity-tested); gzipped files
    and the no-library case fall back to this module's Python parser."""
    with open(path, "rb") as f:
        gzipped = f.read(2) == b"\x1f\x8b"
    if not gzipped and (
            lazy == "on"
            or (lazy == "auto" and os.path.getsize(path) >= _LAZY_AUTO_BYTES)):
        res = _read_lazy(path)
        if res is not None:
            return res
    if not gzipped:
        from telomeri_tpu_torch.native import paf_native

        native = paf_native.parse_fastx(path)
        if native is not None:
            return SequenceSet(native[0], native[1])
    data = _read_bytes(path)
    if not data:
        return SequenceSet([], [])
    if data[0:1] == b">":
        return _parse_fasta(data)
    if data[0:1] == b"@":
        return _parse_fastq(data)
    raise ValueError(f"{path}: not FASTA/FASTQ (first byte {data[0:1]!r})")


read_fastx = read_fasta  # alias; format is auto-detected


def _header_name(line: bytes, what: str) -> str:
    """First whitespace-delimited token after the marker byte; empty -> error."""
    toks = line[1:].split()
    if not toks:
        raise ValueError(f"{what} header with empty sequence name: {line[:30]!r}")
    return toks[0].decode()


def _parse_fasta(data: bytes) -> SequenceSet:
    names: list[str] = []
    seqs: list[np.ndarray] = []
    chunks: list[bytes] = []
    for line in data.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line:
            continue
        if line.startswith(b">"):
            if names:
                seqs.append(np.frombuffer(b"".join(chunks), dtype=np.uint8))
            names.append(_header_name(line, "FASTA"))
            chunks = []
        else:
            chunks.append(line)
    if names:
        seqs.append(np.frombuffer(b"".join(chunks), dtype=np.uint8))
    return SequenceSet(names, seqs)


def _parse_fastq(data: bytes) -> SequenceSet:
    names: list[str] = []
    seqs: list[np.ndarray] = []
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].rstrip(b"\r")
        if not line:
            i += 1
            continue
        if not line.startswith(b"@"):
            raise ValueError(f"FASTQ record {len(names)}: expected '@', got {line[:20]!r}")
        if i + 1 >= n:
            raise ValueError(f"FASTQ record {len(names)}: truncated (header "
                             f"{line[:30]!r} has no sequence line)")
        names.append(_header_name(line, "FASTQ"))
        seqs.append(np.frombuffer(lines[i + 1].rstrip(b"\r"), dtype=np.uint8))
        # lines[i+2] is '+', lines[i+3] is quality — both ignored
        i += 4
    return SequenceSet(names, seqs)


def write_fasta(path: str, names: list[str], seqs: list[np.ndarray], width: int = 80) -> None:
    """Write sequences as FASTA with fixed line width (deterministic byte output)."""
    with open(path, "wb") as f:
        for name, seq in zip(names, seqs):
            f.write(b">" + name.encode() + b"\n")
            b = seq.tobytes()
            for off in range(0, len(b), width):
                f.write(b[off : off + width] + b"\n")

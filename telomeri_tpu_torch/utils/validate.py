"""Scaffold-vs-reference validation (indel-tolerant, alignment-based).

Round 1 validated positionally — sound only for the substitution-only simulator.
Real inputs (PacBio/ONT) are indel-dominated, so round 2 validates by ALIGNMENT
(utils/align.py): unique-k-mer anchor chains + Myers bit-vector edit distance per
inter-anchor segment. A misjoin (wrong repeat-copy pairing) breaks the anchor
chain with a huge genome gap whose edit cost craters identity — the same sharp
signal the positional validator had, now robust to indels.

Per-junction checks (VERDICT round 1 item on misjoin dilution): a misjoin near the
end of a long scaffold barely moves whole-scaffold identity, so validate_assembly
also reports identity in a window around every stitch junction when junction
positions are provided (from Scaffold.segments or an AGP file).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from telomeri_tpu_torch.io.fasta import reverse_complement
from telomeri_tpu_torch.utils.align import ChainAlignment, KmerIndex, chain_align, pack_kmers


@dataclass
class Placement:
    scaffold: str
    genome: str | None      # reference sequence name, None if unplaced
    strand: int             # +1 / -1 (0 if unplaced)
    offset: int             # genome position of the first chained anchor minus its
    #                         scaffold position (approximate start; indels drift it)
    span: int               # alignment columns compared
    identity: float         # 1 - edits/columns over the chain (0.0 if unplaced)
    n_anchors: int = 0
    edits: int = 0
    junctions: list = field(default_factory=list)  # [{pos, identity}] if requested

    def as_dict(self) -> dict:
        d = {"scaffold": self.scaffold, "genome": self.genome,
             "strand": self.strand, "offset": self.offset,
             "span": self.span, "identity": round(self.identity, 6),
             "n_anchors": self.n_anchors, "edits": self.edits}
        if self.junctions:
            d["junctions"] = self.junctions
        return d


_MIN_OK = 0.5  # below this, try the other strand / call unplaced


def _probe_hits(seq: np.ndarray, gidx: KmerIndex, n_probe: int = 2048) -> int:
    """Unique-hit count of ~n_probe evenly-spaced k-mers — a cheap strand/
    reference ordering signal that needs NO full k-mer pack (k gathers of
    n_probe elements)."""
    from telomeri_tpu_torch.utils.align import _CODE_LUT

    k = gidx.k
    n = len(seq) - k + 1
    if n <= 0:
        return 0
    p = np.linspace(0, n - 1, min(n_probe, n)).astype(np.int64)
    km = np.zeros(len(p), np.int64)
    for i in range(k):
        km = (km << 2) | _CODE_LUT[seq[p + i]]
    return int((gidx.lookup_unique(km) >= 0).sum())


def place_scaffold(name: str, scaffold: np.ndarray, genomes: dict, k: int = 24,
                   stride: int = 32, sample: int = 1,
                   must_cover: list | None = None,
                   n_jobs: int = 1) -> Placement:
    """Best alignment-based placement of `scaffold` across reference sequences.

    genomes: {name: array} or {name: (array, KmerIndex)} (index precomputed once
    by validate_assembly). Strands are ordered by a cheap unique-hit probe and
    tried in that order, stopping as soon as one aligns acceptably — the losing
    strand's sequence and full k-mer pack (a real per-scaffold serial cost at
    genome scale) are built lazily only on demand.
    sample/must_cover/n_jobs pass through to chain_align (sampled identity with
    exact junction windows; process-parallel segment evaluation)."""
    best = Placement(name, None, 0, 0, 0, 0.0)
    scaffold = np.asarray(scaffold)
    n_q = len(scaffold)
    # lazy per-strand sequences/packs: the losing strand's full pack (the
    # validator's per-scaffold serial cost) is only built when the winner
    # aligns poorly
    _seqs: dict = {1: scaffold}
    _kms: dict = {}

    def seq_of(s):
        if s not in _seqs:
            _seqs[s] = reverse_complement(scaffold)
        return _seqs[s]

    def km_of(s, k):
        if s not in _kms:
            _kms[s] = pack_kmers(seq_of(s), k)
        return _kms[s]

    for gname, g in genomes.items():
        garr, gidx = g if isinstance(g, tuple) else (
            g, KmerIndex.build(g, k, keep_raw=True))
        # order strands by the cheap probe (round-3 review: always trying +
        # first let a weak wrong-strand chain clear _MIN_OK and skip the true
        # mirror alignment on multi-reference inputs); a zero-hit strand is
        # skipped when the other has hits
        hits = {s: _probe_hits(seq_of(s), gidx) for s in (1, -1)}
        order = sorted((1, -1), key=lambda s: -hits[s])
        for s in order:
            if hits[s] == 0 and hits[order[0]] > 0:
                continue
            # must_cover windows are in FORWARD scaffold coords; mirror for -1
            mc = ([(n_q - hi, n_q - lo) for lo, hi in must_cover]
                  if (must_cover and s == -1) else must_cover)
            al = chain_align(seq_of(s), garr, gidx, stride=stride,
                             qkm=km_of(s, k),
                             sample=sample, must_cover=mc, n_jobs=n_jobs)
            if al is None:
                continue
            if al.identity > best.identity:
                off = int(al.g_anchor[0]) - int(al.q_anchor[0])
                best = Placement(name, gname, s, off, al.columns, al.identity,
                                 n_anchors=al.n_anchors, edits=al.edits)
                best._alignment = al  # noqa: SLF001 — used for junction checks
            if best.identity >= _MIN_OK:
                break  # probe-ordered winner aligned fine; skip the mirror
    return best


def junctions_from_segments(segments: list) -> list[int]:
    """Stitch-junction positions (scaffold coords) from Scaffold.segments rows
    (kind, id, orient, src_start, scaffold_start, length)."""
    return sorted({int(s[4]) for s in segments if int(s[4]) > 0})


def read_agp_junctions(path: str) -> dict[str, list[int]]:
    """Scaffold -> junction positions from an AGP v2.1 file (component starts)."""
    out: dict[str, list[int]] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.rstrip("\n").split("\t")
            name, sc_start = cols[0], int(cols[1])
            if sc_start > 1:
                out.setdefault(name, []).append(sc_start - 1)
    return {n: sorted(set(v)) for n, v in out.items()}


def _want_raw(arr: np.ndarray) -> bool:
    """Keep the position-indexed raw k-mer pack only when it comfortably fits
    in RAM next to everything else. At 3 Gb the raw array is 24 GB; holding
    it anonymous while the sorted arrays (48 GB) stream through the page
    cache and a Gb-scale scaffold packs its own 10+ GB of query k-mers drove
    the kernel into page-cache thrash (round 5, measured: system time >
    user time, 6x superlinear wall). raw is a perf-only slice cache —
    _split_segment re-packs small windows when it is absent."""
    try:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return True
    return 8 * len(arr) <= total // 8


def _cached_index(arr: np.ndarray, k: int, cache_path: str | None,
                  keep_raw: bool = True):
    """KmerIndex for a reference sequence, persisted next to cache_path.

    A genome-scale index build costs tens of minutes (pack + sort of
    ~genome-len keys) and is identical across validate runs of the same
    reference, so the build is RESUMABLE at phase granularity (VERDICT r4
    weak 6: the round-4 all-or-nothing build died mid-save at 3 Gb and
    zeroed 40 min of sort): each of the three arrays carries its OWN
    fingerprint file, written atomically AFTER the array, and the build
    reuses whichever phases already validate —

      raw ok, sorted missing  -> re-sort only (pack skipped)
      sorted ok, raw missing  -> re-pack only (the expensive sort skipped);
                                 raw stays in memory when the disk can't
                                 hold it (24 GB at 3 Gb — the exact failure
                                 that killed the round-4 build)

    Fingerprint: (k, length, crc32 of the full byte buffer) — a real digest
    (one fast pass, ~GB/s at genome scale), so ANY edit to the reference
    invalidates the cache. (The round-3 sum-based fingerprint missed
    sum-preserving edits like base swaps — advisor r3 item 2.) The legacy
    round-4 single-file fingerprint is still honored for reading.

    Layout: the three arrays live as SEPARATE .npy files (cache_path is the
    stem), each loaded with np.load(mmap_mode="r") — reruns start in seconds
    and page in only the k-mers actually probed. np.load silently IGNORES
    mmap_mode for .npz archives (members come back as eager ndarrays —
    advisor r3 item 3), hence one file per array, not an archive."""
    import zlib

    if not cache_path:
        return KmerIndex.build(arr, k, keep_raw=keep_raw)
    crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)))
    fp = np.array([k, len(arr), crc], np.int64)

    def part_ok(p: str) -> bool:
        try:
            return np.array_equal(np.load(f"{cache_path}.{p}.fp.npy"), fp)
        except (OSError, ValueError):
            return False

    def load(p: str):
        return np.load(f"{cache_path}.{p}.npy", mmap_mode="r")

    def save(p: str, a: np.ndarray) -> None:
        # atomic + best-effort: array first, fingerprint LAST, so a crash at
        # any point leaves a per-part miss, never a stale hit. ENOSPC is
        # pre-checked (a doomed 24 GB write would fill the disk for minutes
        # before failing) and any partial tmp is removed on error.
        try:
            st = os.statvfs(os.path.dirname(cache_path) or ".")
            if a.nbytes * 1.05 > st.f_bavail * st.f_frsize:
                log_cache_skip(p, a.nbytes)
                return
            np.save(f"{cache_path}.{p}.tmp.npy", a)
            os.replace(f"{cache_path}.{p}.tmp.npy", f"{cache_path}.{p}.npy")
            np.save(f"{cache_path}.{p}.fp.tmp.npy", fp)
            os.replace(f"{cache_path}.{p}.fp.tmp.npy", f"{cache_path}.{p}.fp.npy")
        except OSError:   # unwritable location: cache is best-effort
            for suf in (f".{p}.tmp.npy", f".{p}.fp.tmp.npy"):
                try:
                    os.remove(cache_path + suf)
                except OSError:
                    pass

    def log_cache_skip(p: str, nbytes: int) -> None:
        from telomeri_tpu_torch.utils.logging import log

        log.warning("index cache: not persisting %s.%s (%.1f GB exceeds free "
                    "disk); kept in memory for this run", cache_path, p,
                    nbytes / 1e9)

    legacy = False
    try:
        legacy = np.array_equal(np.load(cache_path + ".fp.npy"), fp)
    except (OSError, ValueError):
        pass
    sorted_ok = legacy or (part_ok("sorted_km") and part_ok("sorted_pos"))
    raw_ok = legacy or part_ok("raw")
    try:
        if sorted_ok and raw_ok:
            return KmerIndex(k=k, sorted_km=load("sorted_km"),
                             sorted_pos=load("sorted_pos"),
                             raw=load("raw") if keep_raw else None)
        if sorted_ok:      # resume: sort done, only the pack is missing
            km, pos = load("sorted_km"), load("sorted_pos")
            if not keep_raw:
                return KmerIndex(k=k, sorted_km=km, sorted_pos=pos, raw=None)
            raw = pack_kmers(arr, k)
            save("raw", raw)
            return KmerIndex(k=k, sorted_km=km, sorted_pos=pos, raw=raw)
        if raw_ok:         # resume: pack done, only the sort is missing
            idx = KmerIndex.from_packed(np.asarray(load("raw")), k,
                                        keep_raw=keep_raw)
            save("sorted_km", idx.sorted_km)
            save("sorted_pos", idx.sorted_pos)
            return idx
    except (OSError, ValueError):
        pass   # a validated part failed to load: fall through to full build
    # full build — invalidate stale fingerprints FIRST (a crash mid-build
    # must leave misses), persist raw BEFORE the sort so a kill during the
    # sort (the longest phase) keeps the pack
    for f in [cache_path + ".fp.npy"] + [
            f"{cache_path}.{p}.fp.npy" for p in ("sorted_km", "sorted_pos",
                                                 "raw")]:
        try:
            os.remove(f)
        except OSError:
            pass
    raw = pack_kmers(arr, k)
    save("raw", raw)
    idx = KmerIndex.from_packed(raw, k, keep_raw=keep_raw)
    save("sorted_km", idx.sorted_km)
    save("sorted_pos", idx.sorted_pos)
    return idx


def validate_assembly(scaffolds, genomes, k: int = 24, stride: int = 32,
                      junctions: dict[str, list[int]] | None = None,
                      junction_window: int = 2000, sample: int = 1,
                      n_jobs: int = 1,
                      index_cache_dir: str | None = None) -> dict:
    """Validate a scaffold set against reference sequences (indel-tolerant).

    scaffolds/genomes: SequenceSet-shaped (names + seqs). junctions: optional
    {scaffold_name: [positions]} for per-junction identity windows. Returns a
    JSON-ready report: per-scaffold placements plus summary (placed fraction,
    identity weighted by span, worst identity, worst junction identity).

    sample > 1: align every sample-th segment and estimate the rest (CI-speed
    mode; VERDICT r2 item 7). Junction windows and the anchor chain itself stay
    EXACT — the misjoin signal is never sampled away; only the whole-scaffold
    identity becomes an estimate, with ~1-sd error bars in the report
    (identity_stderr per placement, max_identity_stderr in the summary).
    n_jobs > 1: process-parallel segment evaluation, bit-identical results."""
    import time

    from telomeri_tpu_torch.utils.logging import log

    if index_cache_dir:
        try:
            os.makedirs(index_cache_dir, exist_ok=True)
        except OSError:   # unwritable: cache stays best-effort
            pass
    gmap = {}
    t0 = time.perf_counter()
    for i, n in enumerate(genomes.names):
        arr = np.asarray(genomes.seqs[i])
        cache = (os.path.join(index_cache_dir, f"{n}.k{k}.idx")
                 if index_cache_dir else None)
        keep_raw = _want_raw(arr)
        if not keep_raw:
            log.info("validate: %s is genome-scale — not holding the raw "
                     "k-mer pack in RAM (page-cache headroom; repeat-gap "
                     "re-anchoring re-packs windows on demand)", n)
        gmap[n] = (arr, _cached_index(arr, k, cache, keep_raw=keep_raw))
    log.info("validate: indexed %d reference seq(s), %d bp in %.1fs%s",
             len(gmap), int(np.sum(genomes.lengths)), time.perf_counter() - t0,
             f" (cache dir {index_cache_dir})" if index_cache_dir else "")
    placements = []
    worst_junction = None
    max_stderr = 0.0
    for i, name in enumerate(scaffolds.names):
        jpos_list = (junctions or {}).get(name, [])
        windows = [(jp - junction_window, jp + junction_window)
                   for jp in jpos_list]
        p = place_scaffold(name, np.asarray(scaffolds.seqs[i]), gmap, k, stride,
                           sample=sample, must_cover=windows, n_jobs=n_jobs)
        al: ChainAlignment | None = getattr(p, "_alignment", None)
        n_q = int(scaffolds.lengths[i])
        for jpos in jpos_list:
            # junction positions are forward-scaffold coords; a reverse-strand
            # placement aligned the reverse complement, so mirror the window
            jp = (n_q - jpos) if p.strand == -1 else jpos
            ident = (al.identity_in(jp - junction_window, jp + junction_window)
                     if al is not None else 0.0)
            p.junctions.append({"pos": int(jpos), "identity": round(ident, 6)})
            worst_junction = (ident if worst_junction is None
                              else min(worst_junction, ident))
        if al is not None and al.sampled_fraction < 1.0:
            p.as_dict_extra = {
                "sampled_fraction": round(al.sampled_fraction, 4),
                "identity_stderr": round(al.identity_stderr, 6)}
            max_stderr = max(max_stderr, al.identity_stderr)
        log.info("validate: %s (%d bp) -> %s identity %.4f (%.1fs elapsed)",
                 name, n_q, p.genome, p.identity, time.perf_counter() - t0)
        placements.append(p)
    total = int(np.sum(scaffolds.lengths))
    placed_span = sum(p.span for p in placements)
    wsum = sum(p.identity * p.span for p in placements)
    placed = [p for p in placements if p.genome is not None]
    report = {
        "n_scaffolds": len(placements),
        "n_placed": len(placed),
        "total_bases": total,
        "placed_bases": int(placed_span),
        "placed_fraction": round(placed_span / total, 6) if total else 0.0,
        "mean_identity": round(wsum / placed_span, 6) if placed_span else 0.0,
        "worst_identity": round(min((p.identity for p in placed), default=0.0), 6),
        "placements": [dict(p.as_dict(), **getattr(p, "as_dict_extra", {}))
                       for p in placements],
    }
    if sample > 1:
        report["sampled"] = True
        report["max_identity_stderr"] = round(max_stderr, 6)
    if worst_junction is not None:
        report["worst_junction_identity"] = round(worst_junction, 6)
    return report

"""Indel-tolerant sequence alignment for scaffold validation (host, vectorized numpy).

Round-2 validator core (VERDICT round 1 item 1): the reference's real inputs are
PacBio/ONT reads whose errors are indel-dominated, so positional identity is useless
— a single 1-bp indel collapses it to the ~25% random baseline. This module aligns a
scaffold to a known reference genome properly, without external aligners, with
three pieces:

 1. 2-bit packed k-mers + a sorted-array exact-match index (k <= 31 in one int64).
 2. Monotone anchor chaining: unique k-mer matches chained by longest-increasing-
    subsequence on genome position — robust to repeats (non-unique k-mers are
    skipped; inside-repeat gaps are re-anchored RECURSIVELY with locally-unique
    k-mers) and to misjoins (a misjoin breaks the chain into a huge gap whose edit
    cost crashes identity, which is exactly the signal we validate).
 3. Myers bit-vector edit distance (Myers, JACM 1999) over the inter-anchor
    segments: all short segments advance column-by-column in LOCKSTEP as uint64
    lanes (one numpy op per text column for thousands of segments); long
    irreducible segments fall back to a serial multi-word variant.

Identity = 1 - edits / columns over the chained span, where every query base
belongs to exactly one inter-anchor segment and columns = max(qlen, glen) per
segment. Scaffold head/tail are aligned semi-globally (free genome overhang).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_ONE = np.uint64(1)


# byte -> 2-bit code lookup (A,C,G,T -> 0..3; other bytes land where the old
# clip(searchsorted) formula put them — byte-compatible, but ~30x faster than
# searchsorted+clip per call, which profiled at 20% of validator time)
_CODE_LUT = np.clip(
    np.searchsorted(BASES, np.arange(256, dtype=np.uint8)), 0, 3).astype(np.int64)


def _codes(seq: np.ndarray) -> np.ndarray:
    """uint8 bases -> 2-bit codes (A,C,G,T -> 0..3)."""
    return _CODE_LUT[seq]


def _min_dtype(bits: int):
    if bits <= 8:
        return np.uint8
    if bits <= 16:
        return np.uint16
    if bits <= 32:
        return np.uint32
    return np.int64


def pack_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    """All k-mers of seq packed 2 bits/base into int64 (requires 1 <= k <= 31).

    Base at offset 0 lands in the HIGHEST bit pair. Built by doubling —
    j-mers combine into 2j-mers — so a genome-scale pack is O(log k) array
    passes instead of O(k) (2.4x at k=24; this is the validator's single
    largest cost at whole-genome scale). Each doubling level uses the SMALLEST
    dtype holding its 2*2j bits: the passes are memory-traffic-bound, and
    all-int64 levels measured ~4x slower on a 300 Mb genome (round 3)."""
    assert 1 <= k <= 31, k
    if len(seq) < k:
        return np.empty(0, np.int64)
    n = len(seq) - k + 1
    pieces = {1: _CODE_LUT.astype(np.uint8)[seq]}
    j = 1
    while j * 2 <= k:
        a = pieces[j]
        dt = _min_dtype(4 * j)
        pieces[j * 2] = (a[: len(a) - j].astype(dt) << (2 * j)) | a[j:]
        # levels the final combine won't read are dead once doubled past —
        # freeing them eagerly cuts the genome-scale peak by tens of GB
        # (the 3 Gb raw pack must fit in RAM when the disk can't hold it)
        if not (k & j):
            del pieces[j]
        a = None
        j *= 2
    acc = None
    pos = 0
    for j in sorted(pieces, reverse=True):
        if k & j:
            seg = pieces[j][pos : pos + n]
            acc = (seg.astype(np.int64, copy=False) if acc is None
                   else (acc << (2 * j)) | seg)
            pos += j
        del pieces[j]
    return acc if acc.dtype == np.int64 else acc.astype(np.int64)


@dataclass
class KmerIndex:
    """Sorted k-mer index of one sequence (exact-match lookups via searchsorted)."""

    k: int
    sorted_km: np.ndarray   # sorted packed k-mers
    sorted_pos: np.ndarray  # their positions in the sequence
    raw: np.ndarray | None = None  # unsorted packed k-mers (position-indexed);
    #                                kept so sub-windows can SLICE instead of
    #                                re-packing (k-mers are position-local —
    #                                the _split_segment hot path)

    @staticmethod
    def build(seq: np.ndarray, k: int, keep_raw: bool = False) -> "KmerIndex":
        return KmerIndex.from_packed(pack_kmers(seq, k), k, keep_raw=keep_raw)

    @staticmethod
    def from_packed(km: np.ndarray, k: int, keep_raw: bool = False) -> "KmerIndex":
        # Sort order among EQUAL keys is irrelevant: lookup_unique only ever
        # reads positions of k-mers occurring exactly once. Large inputs use
        # the native LSD radix sort (align_native.cpp: 2k-bit keys, byte
        # passes — np.argsort's comparison sort was the dominant serial cost
        # of a genome-scale index build); fallback is unstable np.argsort.
        # Positions are int32 whenever they fit (half the index memory).
        if len(km) >= (1 << 16) and len(km) < 2**31:
            from telomeri_tpu_torch.native import align_native

            res = align_native.radix_argsort_kmers(km, 2 * k)
            if res is not None:
                skm, pos = res
                return KmerIndex(k=k, sorted_km=skm, sorted_pos=pos,
                                 raw=km if keep_raw else None)
        order = np.argsort(km)
        if len(km) < 2**31:
            order = order.astype(np.int32)
        return KmerIndex(k=k, sorted_km=km[order],
                         sorted_pos=order,
                         raw=km if keep_raw else None)

    def lookup_unique(self, query_km: np.ndarray) -> np.ndarray:
        """Position of each query k-mer if it occurs EXACTLY once, else -1."""
        lo = np.searchsorted(self.sorted_km, query_km, "left")
        hi = np.searchsorted(self.sorted_km, query_km, "right")
        pos = np.full(len(query_km), -1, np.int64)
        one = (hi - lo) == 1
        pos[one] = self.sorted_pos[lo[one]]
        return pos


def lis_chain(values: np.ndarray) -> np.ndarray:
    """Indices of a longest STRICTLY-increasing subsequence (patience sorting,
    O(n log n); ties resolved deterministically to the earliest candidates).
    Large inputs use the native port (align_native.cpp, byte-identical output;
    the python loop costs ~10s per million anchors at genome scale)."""
    import bisect

    n = len(values)
    if n == 0:
        return np.empty(0, np.int64)
    if n >= 4096:
        from telomeri_tpu_torch.native import align_native

        res = align_native.lis_chain(values)
        if res is not None:
            return res
    tails: list[int] = []       # smallest tail value of an inc. run of each length
    tails_idx: list[int] = []
    parent = np.full(n, -1, np.int64)
    vals = [int(v) for v in values]
    for i, v in enumerate(vals):
        j = bisect.bisect_left(tails, v)
        if j == len(tails):
            tails.append(v)
            tails_idx.append(i)
        else:
            tails[j] = v
            tails_idx[j] = i
        if j > 0:
            parent[i] = tails_idx[j - 1]
    out = []
    i = tails_idx[-1]
    while i >= 0:
        out.append(i)
        i = parent[i]
    return np.array(out[::-1], np.int64)


# ---------------------------------------------------------------------------
# Myers bit-vector edit distance
# ---------------------------------------------------------------------------

def _myers_batch(qmat: np.ndarray, qlens: np.ndarray,
                 tmat: np.ndarray, tlens: np.ndarray) -> np.ndarray:
    """Global edit distance for a BATCH of (query, target) pairs in lockstep.

    qmat: (n, <=64) uint8 query bases padded with 0xFF; tmat: (n, T) uint8 padded.
    One iteration per text column advances every pair at once (uint64 lanes);
    per-pair state freezes once its own target is exhausted. Bits at and above
    each query's length are harmless: information in the Myers recurrence flows
    only upward (carries, left shifts), so lanes below qlen behave exactly like
    a qlen-bit machine and the score is read at bit qlen-1."""
    n, _ = qmat.shape
    t_cols = tmat.shape[1]
    lanes = np.arange(64, dtype=np.uint64)
    peq = np.zeros((n, 4), np.uint64)
    for c in range(4):
        peq[:, c] = ((qmat == BASES[c]) << lanes[: qmat.shape[1]]).sum(
            axis=1, dtype=np.uint64)
    tcode = _CODE_LUT[tmat]
    rows = np.arange(n)

    pv = np.full(n, ~np.uint64(0))
    mv = np.zeros(n, np.uint64)
    score = qlens.astype(np.int64).copy()
    score_bit = _ONE << (np.maximum(qlens, 1) - 1).astype(np.uint64)
    for j in range(t_cols):
        active = j < tlens
        eq = peq[rows, tcode[:, j]]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        score = score + np.where(active & ((ph & score_bit) != 0), 1, 0)
        score = score - np.where(active & ((mh & score_bit) != 0), 1, 0)
        ph = (ph << _ONE) | _ONE   # global alignment: D[0][j] = j boundary
        mh = mh << _ONE
        pv_new = mh | ~(xv | ph)
        mv_new = ph & xv
        pv = np.where(active, pv_new, pv)
        mv = np.where(active, mv_new, mv)
    # empty queries: distance = target length (the loop never updates score)
    return np.where(qlens == 0, tlens.astype(np.int64), score)


def myers_pair(q: np.ndarray, t: np.ndarray, mode: str = "global") -> int:
    """Edit distance of one (query, target) pair, Myers bit-vector over ONE
    arbitrary-precision Python int (qlen unlimited; ~O(len(t) * len(q)/64)).

    mode: "global" — full q vs full t;
          "free_t_start" — target may start anywhere (head placement);
          "free_t_end"   — target may end anywhere (tail placement).
    """
    m, tn = len(q), len(t)
    if m == 0:
        return 0 if mode != "global" else tn
    if tn == 0:
        return m
    if m > 64:
        # the native word-blocked port wins once the pattern spans multiple
        # words (python bigints are competitive below that); same results
        from telomeri_tpu_torch.native import align_native

        res = align_native.myers_pair(q, t, mode)
        if res is not None:
            return res
    qc = _codes(q)
    peq = [0, 0, 0, 0]
    for i in range(m):
        peq[qc[i]] |= 1 << i
    tcode = _codes(t)
    full = (1 << m) - 1
    top = m - 1
    pv, mv = full, 0
    score = m
    best = score
    hin = 0 if mode == "free_t_start" else 1  # D[0][j] boundary delta
    for j in range(tn):
        eq = peq[tcode[j]]
        xv = eq | mv
        xh = ((((eq & pv) + pv) ^ pv) | eq)
        ph = (mv | ~(xh | pv)) & full
        mh = pv & xh & full
        score += (ph >> top) & 1
        score -= (mh >> top) & 1
        ph = (ph << 1) | hin
        mh = mh << 1
        pv = (mh | ~(xv | ph)) & full
        mv = ph & xv & full
        if mode == "free_t_end" and score < best:
            best = score
    return best if mode == "free_t_end" else score


# ---------------------------------------------------------------------------
# Anchor chaining + segment alignment
# ---------------------------------------------------------------------------

@dataclass
class ChainAlignment:
    """Result of aligning a query to one reference orientation."""

    n_anchors: int
    q_anchor: np.ndarray      # (A,) query positions of chained anchors
    g_anchor: np.ndarray      # (A,) genome positions
    edits: int                # total edit cost over the chained span (+ head/tail)
    columns: int              # total alignment columns (query fully partitioned)
    seg_qlo: np.ndarray       # per-segment query span [qlo, qhi)
    seg_qhi: np.ndarray
    seg_cost: np.ndarray      # per-segment edit cost
    seg_cols: np.ndarray      # per-segment columns
    sampled_fraction: float = 1.0   # fraction of alignable columns aligned
    identity_stderr: float = 0.0    # ~1 sd of identity when sampled (<1.0)

    @property
    def identity(self) -> float:
        return 1.0 - self.edits / self.columns if self.columns else 0.0

    def identity_in(self, qlo: int, qhi: int) -> float:
        """Identity over query window [qlo, qhi): per-segment costs pro-rated by
        query-span overlap (per-junction validation)."""
        span = np.minimum(self.seg_qhi, qhi) - np.maximum(self.seg_qlo, qlo)
        frac = np.clip(span, 0, None) / np.maximum(self.seg_qhi - self.seg_qlo, 1)
        cols = float(np.sum(frac * self.seg_cols))
        cost = float(np.sum(frac * self.seg_cost))
        return 1.0 - cost / cols if cols > 0 else 0.0


_SMALL_Q = 64        # lockstep batch limit (one uint64 word)
_SMALL_T = 192       # batch text-column bound; longer targets go serial
_GIVEUP = 65536      # beyond this, a segment counts as unaligned (cost = columns)


def _split_segment(q: np.ndarray, g: np.ndarray, qlo: int, qhi: int,
                   glo: int, ghi: int, k: int, out: list,
                   qkm: np.ndarray | None = None,
                   gkm: np.ndarray | None = None, k0: int = -1) -> None:
    """Recursively re-anchor a long inter-anchor gap with LOCALLY-unique k-mers
    (repeat interiors have no globally-unique k-mers but are locally unique),
    pushing (qlo, qhi, glo, ghi) leaf segments onto `out`.

    qkm/gkm: optional PRE-PACKED k-mers of the FULL q/g at k0 (position-indexed).
    K-mers are position-local, so a window's k-mers are a plain slice — this
    removes the pack_kmers calls that dominated validator time (26k calls at
    E. coli scale before; profiled 2026-08-20). Recursion that lowers k falls
    back to packing."""
    qlen, glen = qhi - qlo, ghi - glo
    if qlen <= _SMALL_Q or glen <= 0 or k < 11:
        out.append((qlo, qhi, glo, ghi))
        return
    if gkm is not None and k == k0:
        idx = KmerIndex.from_packed(gkm[glo:max(glo, ghi - k + 1)], k)
    else:
        idx = KmerIndex.build(g[glo:ghi], k)
    stride = max(k // 2, 8)
    if qkm is not None and k == k0:
        qk = qkm[qlo:max(qlo, qhi - k + 1)]
    else:
        qk = pack_kmers(q[qlo:qhi], k)
    qp = np.arange(0, len(qk), stride)
    gp = idx.lookup_unique(qk[qp])
    hit = gp >= 0
    qp, gp = qp[hit], gp[hit]
    if len(qp) == 0:
        # no anchors at this k: try a smaller k once, then give up -> leaf
        _split_segment(q, g, qlo, qhi, glo, ghi, k - 6, out, qkm, gkm, k0)
        return
    keep = lis_chain(gp)
    qp, gp = qp[keep] + qlo, gp[keep] + glo
    bounds_q = np.concatenate([[qlo], qp, [qhi]])
    bounds_g = np.concatenate([[glo], gp, [ghi]])
    for i in range(len(bounds_q) - 1):
        a, b = int(bounds_q[i]), int(bounds_q[i + 1])
        c, d = int(bounds_g[i]), int(bounds_g[i + 1])
        if b - a > _SMALL_Q and (b - a, d - c) != (qlen, glen):
            _split_segment(q, g, a, b, c, d, k, out, qkm, gkm, k0)
        else:
            out.append((a, b, c, d))


def _eval_segments(q: np.ndarray, g: np.ndarray,
                   segs: list[tuple[int, int, int, int]]) -> np.ndarray:
    """Exact edit cost of each ALIGNABLE segment (callers filter out the
    _GIVEUP class). Small segments go through the lockstep uint64 batch;
    the rest through the scalar Myers loop."""
    costs = np.zeros(len(segs), np.int64)
    small_q, small_t, small_ix = [], [], []
    for i, (a, b, c, d) in enumerate(segs):
        qlen, glen = b - a, d - c
        if qlen <= _SMALL_Q and glen <= _SMALL_T:
            small_ix.append(i)
            small_q.append(q[a:b])
            small_t.append(g[c:d])
        else:
            costs[i] = myers_pair(q[a:b], g[c:d])
    if small_ix:
        n = len(small_ix)
        qmat = np.full((n, _SMALL_Q), 0xFF, np.uint8)
        tmax = max(len(t) for t in small_t)
        tmat = np.full((n, max(tmax, 1)), 0xFF, np.uint8)
        qlens = np.zeros(n, np.int64)
        tlens = np.zeros(n, np.int64)
        for i, (qs, ts) in enumerate(zip(small_q, small_t)):
            qmat[i, : len(qs)] = qs
            tmat[i, : len(ts)] = ts
            qlens[i], tlens[i] = len(qs), len(ts)
        d = _myers_batch(qmat, qlens, tmat, tlens)
        costs[np.array(small_ix)] = d
    return costs


_PAR: dict = {}   # fork-shared inputs for _par_chunk (copy-on-write, zero pickling)


def _par_chunk(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return idx, _eval_segments(
        _PAR["q"], _PAR["g"], [_PAR["segs"][i] for i in idx])


def _fork_unsafe() -> bool:
    """True when a JAX backend is live in this process: its worker threads make
    fork() deadlock-prone (CPython emits the same warning). The CLI validate
    path never imports jax, so parallel validation normally proceeds;
    library callers inside a jax process silently fall back to serial.
    TELOMERI_FORCE_FORK=1 overrides (tests).

    The probe must NOT initialize a backend itself (jax.extend.backend's
    public get_backend()/backends() would), and as of jax 0.9 no public
    non-initializing liveness check exists — so try the purpose-built
    backends_are_initialized() first, then the registry dict, and fail SAFE
    (assume unsafe -> serial, a performance not correctness fallback) if the
    private layout changes (advisor/verdict r3: the _backends-only probe was
    the repo's one private-API dependency)."""
    import os
    import sys

    if os.environ.get("TELOMERI_FORCE_FORK"):
        return False
    j = sys.modules.get("jax")
    if j is None:
        return False
    try:
        xb = j._src.xla_bridge  # noqa: SLF001
    except AttributeError:
        return True
    for probe in ("backends_are_initialized", "_backends"):
        v = getattr(xb, probe, None)
        if v is not None:
            try:
                return bool(v() if callable(v) else v)
            except Exception:
                return True
    return True   # no recognizable probe: assume unsafe


def _eval_segments_parallel(q, g, segs, n_jobs: int) -> np.ndarray:
    """Fork-based parallel _eval_segments: workers read query/genome through
    copy-on-write memory (nothing big is pickled). Striped index assignment
    balances the few expensive large segments across workers. Results are
    exact ints — identical to the serial path in any job count."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    n = len(segs)
    if n_jobs <= 1 or n < 64 or _fork_unsafe():
        return _eval_segments(q, g, segs)
    stripes = [np.arange(j, n, 4 * n_jobs) for j in range(4 * n_jobs)]
    _PAR.update(q=q, g=g, segs=segs)
    try:
        out = np.zeros(n, np.int64)
        with ProcessPoolExecutor(
                n_jobs, mp_context=mp.get_context("fork")) as ex:
            for idx, costs in ex.map(_par_chunk, stripes):
                out[idx] = costs
    finally:
        _PAR.clear()
    return out


def chain_align(query: np.ndarray, genome: np.ndarray, gidx: KmerIndex,
                stride: int = 32,
                qkm: np.ndarray | None = None, sample: int = 1,
                must_cover: list[tuple[int, int]] | None = None,
                n_jobs: int = 1) -> ChainAlignment | None:
    """Align query to genome via unique-k-mer chaining + per-gap edit distance.

    Returns None when no unique anchor chain exists (unplaceable query).
    gidx must be KmerIndex.build(genome, k) — pass keep_raw=True so repeat-gap
    re-anchoring slices pre-packed k-mers instead of re-packing (perf only).
    stride samples query k-mers; qkm optionally passes pack_kmers(query, k).

    sample > 1 aligns every sample-th alignable segment (plus every segment
    whose query span intersects a must_cover window — junction checks stay
    EXACT) and estimates the rest from the sampled per-column edit rate;
    ChainAlignment.identity_stderr reports ~1 sd of the estimate. The anchor
    CHAIN is always complete, so misjoins (giant genome gaps -> _GIVEUP
    segments, costed directly) are never sampled away.
    n_jobs > 1 parallelizes segment evaluation over processes (exact ints:
    output is identical for any job count)."""
    k = gidx.k
    if qkm is None:
        qkm = pack_kmers(query, k)
    if len(qkm) == 0:
        return None
    qp_all = np.arange(0, len(qkm), stride)
    gp_all = gidx.lookup_unique(qkm[qp_all])
    hit = gp_all >= 0
    qp, gp = qp_all[hit], gp_all[hit]
    if len(qp) == 0:
        return None
    keep = lis_chain(gp)
    qp, gp = qp[keep], gp[keep]

    # partition the query: [0, q0) head, [q_i, q_{i+1}) interior, [q_last, end) tail
    segs: list[tuple[int, int, int, int]] = []
    for i in range(len(qp) - 1):
        a, b = int(qp[i]), int(qp[i + 1])
        c, d = int(gp[i]), int(gp[i + 1])
        if b - a > _SMALL_Q:
            _split_segment(query, genome, a, b, c, d, k, segs,
                           qkm, gidx.raw, k)
        else:
            segs.append((a, b, c, d))

    # classify: _GIVEUP segments are costed by formula (misjoin signal — never
    # sampled away); the alignable rest is aligned exactly or rate-estimated
    costs = np.zeros(len(segs) + 2, np.int64)
    cols = np.zeros(len(segs) + 2, np.int64)
    qlos = np.zeros(len(segs) + 2, np.int64)
    qhis = np.zeros(len(segs) + 2, np.int64)
    align_ix: list[int] = []
    for i, (a, b, c, d) in enumerate(segs):
        qlen, glen = b - a, d - c
        qlos[i], qhis[i] = a, b
        cols[i] = max(qlen, glen)
        if max(qlen, glen) > _GIVEUP:
            costs[i] = max(qlen, glen) - min(qlen, glen) // 2  # unalignable: punitive
        else:
            align_ix.append(i)

    sampled_fraction, identity_stderr = 1.0, 0.0
    if sample <= 1 or len(align_ix) < 8:
        todo = align_ix
        rate_ix: set[int] = set()
    else:
        systematic = set(align_ix[::sample])
        forced: set[int] = set()
        if must_cover:
            # vectorized window->segment intersection (the naive double loop is
            # O(junctions x segments) — measured minutes at genome scale)
            aix = np.array(align_ix)
            lo_a, hi_a = qlos[aix], qhis[aix]
            order = np.argsort(lo_a, kind="stable")
            lo_s, hi_s = lo_a[order], hi_a[order]
            # segments are a sorted partition of the query: intersecting
            # [wlo, whi) is a contiguous run in sorted order
            for (wlo, whi) in must_cover:
                first = int(np.searchsorted(hi_s, wlo, "right"))
                last = int(np.searchsorted(lo_s, whi, "left"))
                forced.update(aix[order[first:last]].tolist())
        # the rest-rate sample must match the REST population: must_cover
        # windows sit over gap fills with far-above-average error AND are all
        # removed from the rest, so both including them in the rate and
        # leaving their share in it biased identity low by up to 0.5% (hg002)
        rate_ix = systematic - forced
        if not rate_ix:
            rate_ix = systematic
        todo = sorted(systematic | forced)
    if todo:
        ev = _eval_segments_parallel(
            query, genome, [segs[i] for i in todo], n_jobs)
        costs[np.array(todo)] = ev
    if todo and len(todo) < len(align_ix):
        # estimate the unaligned remainder from the SYSTEMATIC sample's
        # per-column rate only: must_cover-forced segments (junction windows)
        # are deliberately placed over gap fills whose error rate is far above
        # the scaffold average — including them measured a 0.5%-of-identity
        # downward bias at hg002 scale (round 3)
        rest = np.array(sorted(set(align_ix) - set(todo)))
        sys_ix = np.array(sorted(rate_ix))
        w_ev = cols[sys_ix].astype(np.float64)
        c_ev = costs[sys_ix].astype(np.float64)
        W_ev = float(w_ev.sum())
        rate = float(c_ev.sum()) / W_ev if W_ev else 0.0
        # error-diffusion rounding: naive per-segment rint would zero the
        # expectation on every small segment (rate*32 ~ 0.4 -> 0) and halve
        # the estimated total; cumulative rounding preserves it exactly
        cum = np.rint(np.cumsum(rate * cols[rest].astype(np.float64)))
        costs[rest] = np.diff(np.concatenate([[0.0], cum])).astype(np.int64)
        # ~1 sd: unevaluated segments draw a per-column rate with the sampled
        # weighted variance, independently per segment (approximate — segments
        # are near-iid at anchor-stride scale). The stderr DENOMINATOR must be
        # the same total column count identity uses, which includes the
        # head/tail columns filled in below — finalized after the tail block.
        r_i = np.divide(c_ev, w_ev, out=np.zeros_like(c_ev), where=w_ev > 0)
        s2 = float(np.sum(w_ev * (r_i - rate) ** 2) / W_ev) if W_ev else 0.0
        var_est = s2 * float(np.sum(cols[rest].astype(np.float64) ** 2))
        identity_stderr = float(np.sqrt(var_est))   # numerator; /= cols below
        sampled_fraction = W_ev / max(W_ev + float(cols[rest].sum()), 1.0)

    # head: query[0:q0] vs genome ending at g0, free start (clamped at genome 0)
    nseg = len(segs)
    q0, g0 = int(qp[0]), int(gp[0])
    pad = max(16, q0 // 8)
    hlo = max(0, g0 - q0 - pad)
    clipped_head = (g0 - q0 - pad) < 0 and q0 > g0  # query overhangs genome start
    qlos[nseg], qhis[nseg] = 0, q0
    cols[nseg] = q0
    if q0:
        costs[nseg] = (myers_pair(query[:q0], genome[hlo:g0], "free_t_start")
                       if not clipped_head else max(q0 - g0, 0))
        if clipped_head and g0 > 0:
            costs[nseg] += myers_pair(query[q0 - g0 : q0], genome[:g0], "global")
    # tail: query[q_last:] vs genome starting at g_last, free end
    qL, gL = int(qp[-1]), int(gp[-1])
    qtail = len(query) - qL
    thi = min(len(genome), gL + qtail + max(16, qtail // 8))
    qlos[nseg + 1], qhis[nseg + 1] = qL, len(query)
    cols[nseg + 1] = qtail
    if qtail:
        costs[nseg + 1] = myers_pair(query[qL:], genome[gL:thi], "free_t_end")

    total_cols = int(cols.sum())
    return ChainAlignment(
        n_anchors=len(qp), q_anchor=qp, g_anchor=gp,
        edits=int(costs.sum()), columns=total_cols,
        seg_qlo=qlos, seg_qhi=qhis, seg_cost=costs, seg_cols=cols,
        sampled_fraction=sampled_fraction,
        identity_stderr=identity_stderr / max(total_cols, 1),
    )

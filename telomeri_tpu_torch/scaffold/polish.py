"""Junction polish: consensus re-call of spliced gap-fill bases (round 5).

Why: the stitcher (scaffold/stitch.py) splices RAW read bases into every gap
fill, so junction identity is ceilinged at the read error rate (~99.5% on the
5%-error sim presets; BASELINE.md). But each accepted junction is spanned by
the OTHER reads of its winning group's distinct paths (consensus/evidence.py
attaches them to kept rows as `span_reads`), and coverage ~10-30x sits unused.
This stage re-calls each fill base by plurality over those spanning reads —
the one quality axis where this framework can BEAT a raw-splicing reference
(SURVEY.md §1 match-or-beat north star; VERDICT r4 next-2).

Method (host numpy, fully deterministic):

 1. Per read-sourced fill segment, take the segment plus `polish_flank` bp of
    context on each side as the TARGET.
 2. Anchor every candidate spanning read (both strands; better strand wins by
    unique-hit count) to the target with unique k-mers + LIS chaining
    (utils/align.py machinery), thinned to non-overlapping anchors.
 3. Anchored k-mers vote exact matches; each inter-anchor gap aligns exactly
    (unit-cost DP with deterministic traceback, vectorized rows) and votes
    per target position: a base (match/substitution), a deletion, or an
    insertion string at a boundary.
 4. An edit applies only where >= 2 reads agree AND they outnumber half of
    the covering reads (2*votes > coverage) — so a 50/50 het split keeps the
    representative read's allele, and a single noisy read can never flip a
    base. Ties keep the target. Edits are confined to the fill segment; the
    flanks (contig or neighbouring-segment bases) are never modified.

Determinism: candidates are processed in sorted read order, DP tie-breaks are
fixed (diagonal > up > left), and votes are pure functions of the inputs —
resume ≡ direct byte-identity is preserved (tested).
"""

from __future__ import annotations

import numpy as np

from telomeri_tpu_torch.io.fasta import reverse_complement
from telomeri_tpu_torch.utils.align import KmerIndex, lis_chain, pack_kmers

_K = 15          # anchor k-mer (unique within a <=few-10-kb fill w.h.p.)
_STRIDE = 2      # read-side anchor sampling stride
_MAX_GAP = 2048  # inter-anchor DP cap (bp); larger gaps contribute no votes
_MAX_CANDS = 24  # voters per junction (sorted prefix — plurality saturates)
_B_A, _B_C, _B_G, _B_T = 65, 67, 71, 84
_CH = {65: 0, 67: 1, 71: 2, 84: 3}   # base byte -> vote channel; 4 = deletion
_CH_BYTE = np.array([65, 67, 71, 84], np.uint8)
_CHAN_LUT = np.zeros(256, np.int64)
for _b, _c in _CH.items():
    _CHAN_LUT[_b] = _c


def _anchors(read: np.ndarray, tidx: KmerIndex) -> tuple[np.ndarray, np.ndarray]:
    """LIS-chained unique-k-mer anchors (q_pos, t_pos), thinned so consecutive
    anchors never overlap (each target base gets at most one vote per read)."""
    qkm = pack_kmers(read, tidx.k)
    if not len(qkm):
        return np.empty(0, np.int64), np.empty(0, np.int64)
    qp = np.arange(0, len(qkm), _STRIDE)
    gp = tidx.lookup_unique(qkm[qp])
    hit = gp >= 0
    qp, gp = qp[hit].astype(np.int64), gp[hit].astype(np.int64)
    if len(qp) < 2:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    keep = lis_chain(gp)
    qp, gp = qp[keep], gp[keep]
    # thin to strictly non-overlapping anchors (in BOTH coordinates)
    out_q, out_t = [int(qp[0])], [int(gp[0])]
    for q, t in zip(qp[1:], gp[1:]):
        if q >= out_q[-1] + tidx.k and t >= out_t[-1] + tidx.k:
            out_q.append(int(q))
            out_t.append(int(t))
    return np.array(out_q, np.int64), np.array(out_t, np.int64)


def _strand_hits(read: np.ndarray, tidx: KmerIndex, n_probe: int = 256) -> int:
    """Cheap unique-hit count for strand selection (no LIS)."""
    n = len(read) - tidx.k + 1
    if n <= 0:
        return 0
    p = np.linspace(0, n - 1, min(n_probe, n)).astype(np.int64)
    km = np.zeros(len(p), np.int64)
    from telomeri_tpu_torch.utils.align import _CODE_LUT

    for i in range(tidx.k):
        km = (km << 2) | _CODE_LUT[read[p + i]]
    return int((tidx.lookup_unique(km) >= 0).sum())


def _dp_trace(t: np.ndarray, q: np.ndarray) -> list[tuple[str, int, int]]:
    """Unit-cost global alignment of target gap t vs read gap q with a
    DETERMINISTIC traceback. Returns ops [(kind, t_pos, q_pos)] where kind is
    'M' (q base aligned to t_pos), 'D' (t_pos deleted in read), or
    'I' (q base inserted before t_pos). Rows are vectorized; the left-gap
    serial dependency resolves via the running-min trick (exact)."""
    n, m = len(t), len(q)
    D = np.empty((n + 1, m + 1), np.int32)
    D[0] = np.arange(m + 1)
    col = np.arange(m + 1)
    for i in range(1, n + 1):
        prev = D[i - 1]
        sub = prev[:-1] + (q != t[i - 1])
        nolat = np.minimum(prev[1:] + 1, sub)       # up / diag, no left yet
        nolat = np.concatenate([[i], nolat])
        # left gaps: D[i][j] = min_k<=j (nolat[k] + j - k)
        D[i] = np.minimum.accumulate(nolat - col) + col
    ops: list[tuple[str, int, int]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i][j] == D[i - 1][j - 1] + (t[i - 1] != q[j - 1]):
            ops.append(("M", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and D[i][j] == D[i - 1][j] + 1:
            ops.append(("D", i - 1, j))
            i -= 1
        else:
            ops.append(("I", i, j - 1))
            j -= 1
    ops.reverse()
    return ops


def _gap_ops(t: np.ndarray, q: np.ndarray):
    """(kinds, tpos, qpos) int32 op arrays — native tel_gap_trace when built
    (the python DP was 87% of polish wall time at hg002-sub scale), python
    _dp_trace otherwise; identical output (parity in tests/test_native.py)."""
    from telomeri_tpu_torch.native import align_native

    res = align_native.gap_trace(t, q)
    if res is not None:
        return res
    ops = _dp_trace(t, q)
    code = {"M": 0, "D": 1, "I": 2}
    return (np.array([code[k] for k, _, _ in ops], np.int32),
            np.array([a for _, a, _ in ops], np.int32),
            np.array([b for _, _, b in ops], np.int32))


def _vote_read(read: np.ndarray, tidx: KmerIndex, target: np.ndarray,
               tchan: np.ndarray, sub: np.ndarray, cov: np.ndarray,
               ins: dict) -> bool:
    """Accumulate one read's votes over the target. Returns True if it
    contributed (anchored)."""
    qp, tp = _anchors(read, tidx)
    if len(qp) < 2:
        return False
    k = tidx.k
    # anchored k-mers: exact matches — vote the target's own base. Anchors
    # are non-overlapping, so the positions are unique and fancy += is safe.
    pos = (tp[:, None] + np.arange(k)[None, :]).ravel()
    sub[pos, tchan[pos]] += 1
    # inter-anchor gaps: exact DP votes
    for a in range(len(qp) - 1):
        t0, t1 = int(tp[a]) + k, int(tp[a + 1])
        q0, q1 = int(qp[a]) + k, int(qp[a + 1])
        if t1 - t0 > _MAX_GAP or q1 - q0 > _MAX_GAP:
            continue   # no votes here; span coverage below stays conservative
        if t1 < t0 or q1 < q0:     # crossed thinned anchors cannot happen,
            continue               # but guard the slice anyway
        kinds, tis, qis = _gap_ops(target[t0:t1], read[q0:q1])
        mm = kinds == 0
        if mm.any():   # each target position appears at most once as M or D
            sub[t0 + tis[mm], _CHAN_LUT[read[q0 + qis[mm]]]] += 1
        dm = kinds == 1
        if dm.any():
            sub[t0 + tis[dm], 4] += 1
        im = np.flatnonzero(kinds == 2)
        if len(im):
            # a run of consecutive I ops is ONE inserted string (one vote)
            starts = np.flatnonzero(np.concatenate((
                [True], np.diff(im) != 1)))
            bounds = np.append(starts, len(im))
            for s, e in zip(bounds[:-1], bounds[1:]):
                sel = im[s:e]
                key = (t0 + int(tis[sel[0]]),
                       bytes(read[q0 + qis[sel[0]]: q0 + qis[sel[-1]] + 1]))
                ins[key] = ins.get(key, 0) + 1
    cov[int(tp[0]): int(tp[-1]) + k] += 1
    return True


def polish_region(target: np.ndarray, lo: int, hi: int,
                  candidates: list[np.ndarray]) -> tuple[np.ndarray, dict]:
    """Re-call target[lo:hi] by plurality over candidate spanning reads.

    Returns (new core bytes, stats). Edits apply only where >= 2 reads agree
    and 2*votes > coverage (module docstring); everything else — including
    every base outside [lo, hi) — is returned verbatim."""
    L = len(target)
    tidx = KmerIndex.build(target, _K)
    sub = np.zeros((L, 5), np.int32)
    cov = np.zeros(L, np.int32)
    tchan = _CHAN_LUT[target]
    ins: dict[tuple[int, bytes], int] = {}
    n_used = 0
    for cand in candidates:
        fwd = _strand_hits(cand, tidx)
        rcs = reverse_complement(cand)
        rev = _strand_hits(rcs, tidx)
        if max(fwd, rev) == 0:
            continue
        n_used += _vote_read(cand if fwd >= rev else rcs, tidx, target,
                             tchan, sub, cov, ins)
    stats = {"reads_used": n_used, "subs": 0, "dels": 0, "ins": 0}
    if n_used == 0:
        return target[lo:hi].copy(), stats
    # insertion winners per boundary (plurality among non-empty strings;
    # ties -> lexicographically smallest; must beat half the covering reads)
    ins_at: dict[int, tuple[bytes, int]] = {}
    for (p, s), c in sorted(ins.items()):
        best = ins_at.get(p)
        if best is None or c > best[1]:
            ins_at[p] = (s, c)
    out = bytearray()
    win = np.argmax(sub, axis=1)            # argmax: lowest channel on ties
    win_n = sub[np.arange(L), win]
    t_n = sub[np.arange(L), tchan]
    apply_row = (win_n >= 2) & (2 * win_n > cov) & (win_n > t_n)
    for j in range(lo, hi):
        b = ins_at.get(j)
        if b is not None and b[1] >= 2 and 2 * b[1] > int(cov[j]):
            out.extend(b[0])
            stats["ins"] += 1
        if apply_row[j]:
            if win[j] == 4:
                stats["dels"] += 1
            else:
                out.append(int(_CH_BYTE[win[j]]))
                stats["subs"] += 1
        else:
            out.append(int(target[j]))
    return np.frombuffer(bytes(out), np.uint8), stats


def polish_scaffolds(scaffolds: list, reads, junction_reads: dict,
                     n_contigs: int, flank: int = 96,
                     log=None) -> dict:
    """Polish every read-sourced fill segment of every scaffold IN PLACE.

    junction_reads: {canonical pair -> list of GLOBAL seq ids} (spanning-read
    sets from the cut-read gate / rescue paths). Segment -> bridge mapping:
    read segments between the k-th and (k+1)-th contig segment belong to
    Scaffold.bridges[k]. Scaffold seq + segments are rebuilt with shifted
    coordinates; AGP source coordinates keep describing the pre-polish splice
    (config.py `polish` docstring). Returns aggregate stats."""
    agg = {"segments": 0, "reads_used": 0, "subs": 0, "dels": 0, "ins": 0,
           "delta_bp": 0}
    for sc in scaffolds:
        if not sc.bridges or not any(s[0] == "read" for s in sc.segments):
            continue
        parts: list[np.ndarray] = []
        new_segments = []
        pos = 0
        k = -1                      # bridges[k] owns read segs after contig k
        for (kind, sid, orient, src_start, sc_start, ln) in sc.segments:
            raw = sc.seq[sc_start: sc_start + ln]
            if kind == "contig":
                k += 1
            elif 0 <= k < len(sc.bridges):
                pair = tuple(sc.bridges[k].pair)
                span = junction_reads.get(pair, [])
                # candidates: the pair's OTHER spanning reads (global sid ->
                # read index; the segment's own source read already IS the
                # target and must not double-vote)
                cand = [np.asarray(reads.seqs[g - n_contigs])
                        for g in span[:_MAX_CANDS]
                        if g >= n_contigs and (g - n_contigs) != sid]
                if cand:
                    lo = max(0, sc_start - flank)
                    hi = min(len(sc.seq), sc_start + ln + flank)
                    tgt = np.asarray(sc.seq[lo:hi])
                    core, st = polish_region(
                        tgt, sc_start - lo, sc_start - lo + ln, cand)
                    agg["segments"] += 1
                    for f in ("reads_used", "subs", "dels", "ins"):
                        agg[f] += st[f]
                    agg["delta_bp"] += len(core) - ln
                    raw = core
            parts.append(raw)
            new_segments.append((kind, sid, orient, src_start, pos, len(raw)))
            pos += len(raw)
        sc.seq = np.concatenate(parts) if parts else sc.seq
        sc.segments = new_segments
    if log is not None and agg["segments"]:
        log.info(
            "polish: %d fill segment(s), %d spanning-read alignments; "
            "%d subs, %d dels, %d ins (net %+d bp)", agg["segments"],
            agg["reads_used"], agg["subs"], agg["dels"], agg["ins"],
            agg["delta_bp"])
    return agg

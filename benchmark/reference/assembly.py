"""Judge a scaffolds FASTA against the simulated genome it was assembled from.

The simulator cuts the genome into contigs at its repeat copies, so the truth
of every join is known: contig i is followed in the genome by contig i + 1 on
the same strand. A scaffolder promises (the `ecoli` configuration states it):

  - every contig is placed once, its bases as given (contig_errors = 0);
  - every join puts two genome neighbours side by side, on one strand
    (misjoins = 0);
  - a join spans the genome's distance between them, up to the indels of the
    read that fills it (gap_error_bp, the largest difference over the joins);
  - the repeats are bridged (joins_missing: genome neighbours left apart);
  - every other base is the genome's too, up to the errors of the reads that
    fill a join (join_edits, end_edits, unplaced_bases).

A contig is found by its interior, the contig less `margin` bases at each end
(the stitcher trims contig ends where a read takes over, by less than a read's
length), as an exact substring of a scaffold on either strand. The bases
between two interiors found next to each other (both margins, the contig ends
the stitcher trimmed, the fill) are held to the genome between them
by edit distance, and so are the bases before a scaffold's first interior and
after its last. A scaffold in which no interior is found is counted whole as
unplaced. So every base of every scaffold is compared. Plain numpy and bytes,
nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def read_fasta(path: str) -> list[tuple[str, bytes]]:
    """[(name, sequence)] of a FASTA file, in file order."""
    out: list[tuple[str, list[bytes]]] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                out.append((line[1:].split()[0].decode(), []))
            elif out:
                out[-1][1].append(line)
    return [(name, b"".join(parts)) for name, parts in out]


def interiors(contig_pos, margin: int = 25_000) -> list[tuple[int, int]]:
    """Each contig's genome interval less `margin` bases at each end (at most a
    quarter of the contig)."""
    spans = []
    for a, b in contig_pos:
        m = min(margin, (b - a) // 4)
        spans.append((a + m, b - m))
    return spans


def edit_distance(a: bytes, b: bytes) -> int:
    """Levenshtein distance of a and b (unit costs, global), by the bit-vector
    recurrence of Myers (1999) in Hyyro's global form, a column of the table a
    Python integer."""
    if len(a) < len(b):
        a, b = b, a
    m = len(b)
    if m == 0:
        return len(a)
    peq: dict[int, int] = {}
    for i, c in enumerate(b):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    top = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in a:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = (mv | ~(xh | pv)) & mask
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = (mh | ~(xv | ph)) & mask
        mv = ph & xv
    return score


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    diff = np.frombuffer(a, np.uint8, n) != np.frombuffer(b, np.uint8, n)
    return int(np.argmax(diff)) if diff.any() else n


def stretch_edits(got: bytes, want: bytes) -> int:
    """Edits that turn `want` into `got`: the exact matches at both ends taken
    as they stand, the rest by edit_distance (an upper bound on the distance
    of the whole, equal to it where the ends match)."""
    head = _common_prefix(got, want)
    got, want = got[head:], want[head:]
    tail = _common_prefix(got[::-1], want[::-1])
    if tail:
        got, want = got[:-tail], want[:-tail]
    return edit_distance(got, want)


def _oriented(genome: bytes, lo: int, hi: int, strand: int) -> bytes:
    seg = genome[max(lo, 0):max(hi, 0)]
    return seg if strand == 1 else revcomp(seg)


def judge(scaffolds: list[tuple[str, bytes]], genome: bytes, contig_pos,
          margin: int = 25_000) -> dict:
    """The numbers above for one assembly's scaffolds."""
    spans = interiors(contig_pos, margin)
    found: dict[int, list[tuple[int, int, int]]] = {i: [] for i in range(len(spans))}
    for si, (_, seq) in enumerate(scaffolds):
        for ci, (lo, hi) in enumerate(spans):
            fwd = genome[lo:hi]
            for strand, pat in ((1, fwd), (-1, revcomp(fwd))):
                p = seq.find(pat)
                while p >= 0:
                    found[ci].append((si, p, strand))
                    p = seq.find(pat, p + 1)
    contig_errors = sum(1 for hits in found.values() if len(hits) != 1)
    by_scaffold: dict[int, list[tuple[int, int, int]]] = {}
    for ci, hits in found.items():
        if len(hits) == 1:
            si, p, strand = hits[0]
            by_scaffold.setdefault(si, []).append((p, ci, strand))
    misjoins = joins = 0
    gap_error = join_edits = end_edits = 0
    unplaced = sum(len(seq) for si, (_, seq) in enumerate(scaffolds) if si not in by_scaffold)
    for si, placed in by_scaffold.items():
        seq = scaffolds[si][1]
        placed.sort()
        for (p1, c1, s1), (p2, c2, s2) in zip(placed, placed[1:]):
            if s1 != s2 or c2 != c1 + s1:
                misjoins += 1
                continue
            joins += 1
            (lo1, hi1), (lo2, hi2) = spans[c1], spans[c2]
            got = seq[p1 + (hi1 - lo1):p2]
            want = _oriented(genome, hi1, lo2, 1) if s1 == 1 else _oriented(genome, hi2, lo1, -1)
            gap_error = max(gap_error, abs(len(got) - len(want)))
            join_edits = max(join_edits, stretch_edits(got, want))
        # the scaffold's ends, against as many genome bases beside the outer interiors
        (p, c, s), (q, d, t) = placed[0], placed[-1]
        head, tail = seq[:p], seq[q + spans[d][1] - spans[d][0]:]
        lo, hi = spans[c]
        want = (_oriented(genome, lo - len(head), lo, 1) if s == 1
                else _oriented(genome, hi, hi + len(head), -1))
        end_edits = max(end_edits, stretch_edits(head, want))
        lo, hi = spans[d]
        want = (_oriented(genome, hi, hi + len(tail), 1) if t == 1
                else _oriented(genome, lo - len(tail), lo, -1))
        end_edits = max(end_edits, stretch_edits(tail, want))
    return dict(misjoins=misjoins, contig_errors=contig_errors,
                joins_missing=len(spans) - 1 - joins, gap_error_bp=gap_error,
                join_edits=join_edits, end_edits=end_edits, unplaced_bases=unplaced)


def load_truth(genome_path: str, truth_path: str) -> tuple[bytes, list[tuple[int, int]]]:
    """The genome's bases and the contigs' genome intervals, as the benchmark's
    simulator wrote them."""
    genome = read_fasta(genome_path)[0][1]
    pos = np.load(truth_path)["contig_pos"]
    return genome, [(int(a), int(b)) for a, b in pos]

"""Cut-read gate: the host half of read-diverse consensus support (round 4).

A winning length-group with >= min_group_support DISTINCT paths (counted on
device by consensus/grouping.py, support_mode="read_diverse") is still refused
if one read appears in EVERY distinct path: a chimeric read fabricates a
junction that only IT spans, so every path through the fake junction contains
it, at any walk density. True junctions spanned by a single read fail the same
test — on PAF evidence alone they are indistinguishable from chimeras
(BASELINE.md hg002 gaps 145/306) — which is the documented, deliberate refusal.

This was the rescue-round acceptance rule in round 3 (walk/rescue.py); round 4
makes it normative for the BASE consensus too, so base walk density can rise to
whatever the chip gives without inflating support (VERDICT r3 next-#1).

The gate inspects only the flagged distinct-representative rows
(ConsensusResult.win_distinct — a handful per bridge), so it stays cheap at any
walk density and needs only a tiny collective fetch when the walk records are
left on a mesh's ranks (dist/mesh.py fetch_walk_rows, the stitch-stage mechanism).

The port of telomeri_tpu/consensus/evidence.py: the reference's host numpy
gate, with this package's fetch of sharded records.
"""

from __future__ import annotations

import numpy as np

from telomeri_tpu_torch.dist.mesh import ShardedWalks, fetch_walk_rows
from telomeri_tpu_torch.utils.logging import log


def interior_reads(nodes_row: np.ndarray, steps_i: int,
                   virtual_base: int) -> frozenset:
    """Set of read SEQUENCE ids on one walk's interior (hop nodes stripped,
    oriented node -> sequence via // 2)."""
    return frozenset(int(x) // 2 for x in nodes_row[1:steps_i]
                     if 0 <= x < virtual_base)


def read_diversity_gate(
    rows: list[dict], cons, walks, virtual_base: int, mesh=None,
    split_read: np.ndarray | None = None,
) -> tuple[list[dict], list[dict]]:
    """Filter compress() bridge rows by the cut-read rule with split-read
    discrimination.

    A pair with a CUT read (one read on every distinct path) is single-point
    evidence. Round 4 resolves it by the read's MAPPING GEOMETRY
    (io/geometry.py split_mapped): a chimeric read is split-mapped (disjoint
    alignment clusters — the aligner's own chimera signature), while a clean
    spanning read maps as one contiguous cluster. So:

      - cut reads exist, at least one is CLEAN  -> keep (a contiguous read
        really spans the junction; a chimera cannot produce a clean cut read
        for a fake junction — a clean read connecting the two loci would mean
        the loci ARE adjacent);
      - cut reads exist, ALL split-mapped (or no split info) -> BLOCK.

    Blocked rows are NOT discarded: the caller must pass them to
    scaffold.bridge.resolve_with_blockers, where they claim their ends in
    support order without stitching — measured on hg002-sub at 1000 walks/end,
    silently dropping a refused 389-walk true pair let a 2-walk read-diverse
    wrong-copy bridge claim its ends (a misjoin).

    rows: consensus/compress() dicts (already min_support-filtered).
    cons: the ConsensusResult they came from (win_distinct must be present).
    walks: the WalkResult those rows were grouped from — host numpy OR
        ShardedWalks left on their ranks (pass mesh; the flagged rows are
        fetched via the stitch-stage collective).
    split_read: (n_seqs,) bool from GraphTensors.split_read; None (e.g. a
        pre-round-4 graph artifact) treats every cut read as suspect.
    Returns (kept_rows, blocked_rows); both carry cut-read diagnostics.
    """
    if not rows:
        return rows, []
    if cons.win_distinct is None:
        raise ValueError("read_diversity_gate needs a read_diverse consensus "
                         "(ConsensusResult.win_distinct is None)")
    idx = np.flatnonzero(np.asarray(cons.win_distinct))
    if isinstance(walks, ShardedWalks):
        if mesh is None:
            raise ValueError("records left on their ranks need the mesh to fetch them")
        mini = fetch_walk_rows(walks, idx, mesh)
        nodes, steps, terms = mini.nodes, mini.steps, mini.terminal
    else:
        nodes = np.asarray(walks.nodes)[idx]
        steps = np.asarray(walks.steps)[idx]
        terms = np.asarray(walks.terminal)[idx]

    # Vectorized cut-read computation (the flagged-row count scales with
    # pair count x distinct paths — ~25k on hg002-sub, ~10x that at full
    # genome scale, so per-row Python set building is the wrong altitude):
    # a pair's cut reads are the reads whose DISTINCT-flagged-row count for
    # that pair equals the pair's flagged-row count.
    nodes = np.asarray(nodes)
    steps = np.asarray(steps).astype(np.int64)
    terms = np.asarray(terms).astype(np.int64)
    a0 = nodes[:, 0].astype(np.int64)
    ra, rb = terms ^ 1, a0 ^ 1
    flip = (ra < a0) | ((ra == a0) & (rb < terms))
    ca = np.where(flip, ra, a0)
    cb = np.where(flip, rb, terms)
    pair_key = {}
    pair_of_row = np.empty(len(idx), np.int64)
    for r in range(len(idx)):         # tiny: one dict op per flagged row
        pair_of_row[r] = pair_key.setdefault((int(ca[r]), int(cb[r])),
                                             len(pair_key))
    n_pairs = len(pair_key)
    col = np.arange(nodes.shape[1])[None, :]
    m = (col >= 1) & (col < steps[:, None]) & (nodes >= 0) & (nodes < virtual_base)
    rowi, coli = np.nonzero(m)
    reads_f = nodes[rowi, coli].astype(np.int64) // 2
    # distinct (row, read), then distinct-row count per (pair, read)
    n_reads = int(reads_f.max()) + 1 if reads_f.size else 1
    rr = np.unique(rowi * n_reads + reads_f)
    pid = pair_of_row[rr // n_reads]
    uk, cnt = np.unique(pid * n_reads + rr % n_reads, return_counts=True)
    rows_per_pair = np.bincount(pair_of_row, minlength=n_pairs)
    is_cut = cnt == rows_per_pair[uk // n_reads]
    cuts: dict[int, list[int]] = {}
    for k in uk[is_cut]:
        cuts.setdefault(int(k // n_reads), []).append(int(k % n_reads))
    # per-pair union of reads across ALL its distinct paths — the junction's
    # spanning-read set, attached to kept rows for the polish stage
    # (scaffold/polish.py): these reads each cross the junction and are the
    # voters that re-call the spliced fill bases
    span: dict[int, list[int]] = {}
    for k in uk:
        span.setdefault(int(k // n_reads), []).append(int(k % n_reads))

    kept, blocked = [], []
    for row in rows:
        pid_row = pair_key.get(tuple(row["pair"]))
        if pid_row is None:
            # Anomaly: every valid bridge row has flagged distinct members, so
            # a missing pair signals win_distinct/compress drift upstream. The
            # unsafe direction is ACCEPTING such a bridge — fail CLOSED:
            # refuse and block its ends like any other suspect pair (VERDICT
            # r4 weak 3: the round-4 "defensively keep" failed open).
            log.warning("cut-read gate: no flagged paths for pair %s — "
                        "upstream inconsistency; refusing and blocking its "
                        "ends (fail closed)", row["pair"])
            blocked.append(dict(row, cut_reads=[], gate_anomaly=True))
            continue
        row = dict(row, span_reads=sorted(span.get(pid_row, [])))
        cut = cuts.get(pid_row, [])
        if not cut:
            kept.append(row)
            continue
        clean = ([] if split_read is None
                 else [r for r in cut if not bool(split_read[r])])
        if clean:
            log.info(
                "consensus: pair %s hangs on cut read(s) %s but %s map(s) "
                "contiguously (not split) — clean spanning read, accepted",
                row["pair"], sorted(cut), sorted(clean))
            kept.append(dict(row, cut_reads=sorted(cut)))
        else:
            log.info(
                "consensus: pair %s has %d distinct paths but cut read(s) %s, "
                "all %s — single-point evidence, refused; ends will be "
                "blocked, not freed",
                row["pair"], row.get("distinct", row["count"]), sorted(cut),
                "split-mapped (chimera signature)" if split_read is not None
                else "of unknown mapping (no split info)")
            blocked.append(dict(row, cut_reads=sorted(cut)))
    return kept, blocked

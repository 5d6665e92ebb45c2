"""Copy-coherence demotion: rank wrong-copy bridge hypotheses below true ones
(round 5).

The failure this addresses, measured on a fresh hg002-sub instance (BASELINE.md
"wrong-copy hijack case study"): at a coverage dip, a contig end's walks can
funnel through a CROSS-COPY alignment into a different repeat locus's
perfectly genuine gap evidence, fabricating a bridge between distant contigs.
Such a pair can tie (or beat) the true pair's raw count, and the cut-read gate
cannot catch it — the bottleneck read maps contiguously at ITS OWN locus; the
fabrication lives in another edge of the path.

The signal that does separate them is the HERA premise itself: repeat copies
DIVERGE. A cross-copy alignment's sequence identity sits ~copy-divergence
below the same-locus level of the reads involved. Absolute SI thresholds are
untunable (identity varies with read error), and a read's MEDIAN incident SI
is itself cross-dominated inside repeats — but the TOP of a read's incident
SI distribution (p90) tracks its same-locus level. So:

    rel(edge) = SI(edge) - min(p90_SI(src seq), p90_SI(dst seq))

Measured on the failing dataset: every wrong pair's BEST distinct path had
min-edge rel <= +0.0007, while every competing true pair had a path with
min-edge rel >= +0.0126 (copy_divergence 0.02). A pair is COHERENT when some
flagged distinct path keeps every edge's rel >= copy_coherence_margin.

Crucially this is a DEMOTION, not a gate: conflict resolution ranks
incoherent pairs below coherent ones at equal support count
(scaffold/bridge.py). On datasets without cross-copy structure the flag is
uniform and the ordering is unchanged — safe by construction; it can
re-order, never refuse. The measured residual risk (a one-sided wrong pair
claiming an end with NO competing evidence) is documented in BASELINE.md.

The port of telomeri_tpu/consensus/coherence.py: the reference's host numpy
code, with this package's fetch of records left on a mesh's ranks.
"""

from __future__ import annotations

import numpy as np

from telomeri_tpu_torch.dist.mesh import ShardedWalks, fetch_walk_rows
from telomeri_tpu_torch.scaffold.stitch import extract_path


def edge_coherence_rel(edges) -> np.ndarray:
    """(n_edges,) float64: each edge's SI minus the lower of its endpoints'
    p90 incident SI (numpy-percentile 'linear' semantics, exactly)."""
    n_e = len(edges)
    si = edges.nm.astype(np.float64) / np.maximum(edges.bl, 1)
    if n_e == 0:
        return si
    seq_of = np.concatenate([edges.src.astype(np.int64) // 2,
                             edges.dst.astype(np.int64) // 2])
    si2 = np.concatenate([si, si])
    n_seqs = int(seq_of.max()) + 1
    order = np.lexsort((si2, seq_of))
    so, sv = seq_of[order], si2[order]
    bounds = np.searchsorted(so, np.arange(n_seqs + 1))
    cnt = np.diff(bounds)
    p90 = np.full(n_seqs, np.inf)     # seqs with no edges never referenced
    has = np.flatnonzero(cnt > 0)
    rank = 0.9 * (cnt[has] - 1)
    fl = np.floor(rank)
    lo_i = bounds[has] + fl.astype(np.int64)
    hi_i = np.minimum(lo_i + 1, bounds[has] + cnt[has] - 1)
    frac = rank - fl
    p90[has] = sv[lo_i] * (1 - frac) + sv[hi_i] * frac
    ref = np.minimum(p90[edges.src.astype(np.int64) // 2],
                     p90[edges.dst.astype(np.int64) // 2])
    return si - ref


def annotate_pair_coherence(rows: list, cons, walks, edges,
                            virtual_base: int, margin: float,
                            mesh=None) -> int:
    """Set row["coherent"] / row["coherence"] on each bridge row.

    coherent = some win_distinct-flagged path of the pair has EVERY edge's
    rel >= margin; coherence = that path's min-edge rel (the pair's best).
    Mutates `rows` in place; returns the number of incoherent pairs.
    Uses the same flagged-row fetch as the cut-read gate (tiny collective
    when records are device-sharded)."""
    if not rows or margin <= 0:
        for r in rows:
            r["coherent"] = True
        return 0
    if cons.win_distinct is None:
        raise ValueError("annotate_pair_coherence needs a read_diverse "
                         "consensus (win_distinct is None)")
    rel = edge_coherence_rel(edges)
    idx = np.flatnonzero(np.asarray(cons.win_distinct))
    if isinstance(walks, ShardedWalks):
        if mesh is None:
            raise ValueError("records left on their ranks need the mesh to fetch them")
        mini = fetch_walk_rows(walks, idx, mesh)
        nodes, eids = np.asarray(mini.nodes), np.asarray(mini.eids)
        steps, terms = np.asarray(mini.steps), np.asarray(mini.terminal)
    else:
        nodes = np.asarray(walks.nodes)[idx]
        eids = np.asarray(walks.eids)[idx]
        steps = np.asarray(walks.steps)[idx].astype(np.int64)
        terms = np.asarray(walks.terminal)[idx].astype(np.int64)
    a0 = nodes[:, 0].astype(np.int64)
    t = np.asarray(terms, np.int64)
    ra, rb = t ^ 1, a0 ^ 1
    flip = (ra < a0) | ((ra == a0) & (rb < t))
    ca = np.where(flip, ra, a0)
    cb = np.where(flip, rb, t)
    best: dict[tuple[int, int], float] = {}
    for r in range(len(idx)):
        wp = extract_path(nodes[r], eids[r], int(steps[r]),
                          virtual_base=virtual_base)
        m = float(min((rel[e] for e in wp.eids), default=np.inf))
        key = (int(ca[r]), int(cb[r]))
        if key not in best or m > best[key]:
            best[key] = m
    n_inc = 0
    for row in rows:
        b = best.get(tuple(row["pair"]), -np.inf)
        row["coherence"] = round(b, 6) if np.isfinite(b) else None
        row["coherent"] = bool(b >= margin)
        n_inc += not row["coherent"]
    return n_inc

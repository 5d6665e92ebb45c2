"""Copy-coherence demotion: telomeri_tpu/consensus/coherence.py with the port's
row fetch (as consensus/evidence.py does for the cut-read gate)."""

from __future__ import annotations

from telomeri_tpu.consensus import coherence as _ref
from telomeri_tpu_torch.consensus.evidence import fetch_flagged_rows
from telomeri_tpu_torch.dist.mesh import ShardedWalks


def annotate_pair_coherence(rows: list, cons, walks, edges, virtual_base: int,
                            margin: float, mesh=None) -> int:
    """The reference's annotate_pair_coherence (same arguments and results);
    walks may be host records or ShardedWalks with their mesh."""
    if (rows and margin > 0 and cons.win_distinct is not None
            and isinstance(walks, ShardedWalks)):
        walks, cons = fetch_flagged_rows(cons, walks, mesh)
    return _ref.annotate_pair_coherence(rows, cons, walks, edges, virtual_base, margin)

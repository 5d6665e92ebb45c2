"""Cut-read gate: telomeri_tpu/consensus/evidence.py with the port's row fetch.

The gate is the reference's own host-numpy code. Only its fetch of the flagged
rows changes: where the records were left on their ranks (dist/mesh.py
ShardedWalks), the flagged rows come to every rank through the port's
fetch_walk_rows, and the reference's gate then reads them as host records. The
reference reaches its own fetch through telomeri_tpu.dist.mesh, which imports
jax.
"""

from __future__ import annotations

import numpy as np

from telomeri_tpu.consensus import evidence as _ref
from telomeri_tpu_torch.dist.mesh import ShardedWalks, fetch_walk_rows


def fetch_flagged_rows(cons, walks: ShardedWalks, mesh):
    """(host records of the win_distinct-flagged rows, cons whose win_distinct
    flags exactly those rows): what the reference's gate reads, fetched."""
    if mesh is None:
        raise ValueError("records left on their ranks need the mesh to fetch them")
    idx = np.flatnonzero(np.asarray(cons.win_distinct))
    return (fetch_walk_rows(walks, idx, mesh),
            cons._replace(win_distinct=np.ones(len(idx), bool)))


def read_diversity_gate(rows: list[dict], cons, walks, virtual_base: int, mesh=None,
                        split_read: np.ndarray | None = None):
    """The reference's read_diversity_gate (same arguments and results); walks
    may be host records or ShardedWalks with their mesh."""
    if rows and cons.win_distinct is not None and isinstance(walks, ShardedWalks):
        walks, cons = fetch_flagged_rows(cons, walks, mesh)
    return _ref.read_diversity_gate(rows, cons, walks, virtual_base,
                                    split_read=split_read)

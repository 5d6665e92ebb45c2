"""Walk batch planning (host): enumerate the deterministic + Monte-Carlo walks.

Reference parity: the C++ reference's PathManager path generation (SURVEY.md §3 rows 7-9;
mount empty, SURVEY.md §0). Following the HERA scheme, for every anchor END (oriented
anchor node with out-degree > 0) we plan:

  - one greedy-by-OS walk per first edge   (deg walks, mode 0)
  - one greedy-by-ES walk per first edge   (deg walks, mode 1)
  - cfg.mc_walks_per_end Monte-Carlo walks (mode 2, first edge sampled like any step)

Batch layout (performance — see walk/engine.py): the plan is SECTIONED by kind,
[greedy | padding | mc | padding], so the engine can run a specialized scan per
section (the MC scan needs no OS gather, no greedy argmax, no forced-first-edge
handling). Each section is padded to a multiple of cfg.walk_batch_multiple * n_shards
for even sharding.

Walk uids are assigned BEFORE padding (greedy walks 0..G-1, MC walks G..G+M-1,
padding rows get uids >= G+M), so a walk's RNG stream and tie-break rank depend only
on the enumeration — invariant to batch size, padding, shard count, and host count
(SURVEY.md §5 item 3). Row order equals uid order within each section, but NOT
globally; map uids to rows with `WalkPlan.uid_to_row`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors

MODE_GREEDY_OS = 0
MODE_GREEDY_ES = 1
MODE_MC = 2


@dataclass
class WalkPlan:
    """SoA walk parameters, device-ready. All arrays share length W (padded)."""

    start: np.ndarray       # int32 start node (oriented anchor); 0 for inactive pads
    first_edge: np.ndarray  # int32 CSR slot for step 0, or -1 = choose by mode
    mode: np.ndarray        # int32 MODE_*
    uid: np.ndarray         # int32 stable global walk id
    active: np.ndarray      # bool
    # row ranges per kind: {"greedy": (lo, hi), "mc": (lo, hi)}; None = mixed/unknown
    sections: dict | None = field(default=None)

    def __len__(self) -> int:
        return len(self.start)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def uid_to_row(self) -> np.ndarray:
        """Lookup table: row index of each uid (-1 for absent uids)."""
        lut = np.full(int(self.uid.max()) + 2 if len(self.uid) else 1, -1, np.int64)
        lut[self.uid] = np.arange(len(self.uid))
        return lut


def plan_walks(g: GraphTensors, cfg: ScaffoldConfig, n_shards: int = 1) -> WalkPlan:
    ends = np.flatnonzero(g.anchor_mask() & (g.deg > 0)).astype(np.int64)
    m = cfg.walk_batch_multiple * max(n_shards, 1)

    # greedy section
    g_start, g_first, g_mode = [], [], []
    for a in ends:
        d = int(g.deg[a])
        for mode in (MODE_GREEDY_OS, MODE_GREEDY_ES):
            g_start.append(np.full(d, a))
            g_first.append(np.arange(d))
            g_mode.append(np.full(d, mode))
    g_start = np.concatenate(g_start) if g_start else np.empty(0, np.int64)
    g_first = np.concatenate(g_first) if g_first else np.empty(0, np.int64)
    g_mode = np.concatenate(g_mode) if g_mode else np.empty(0, np.int64)
    n_greedy = len(g_start)

    # mc section
    n_mc = len(ends) * cfg.mc_walks_per_end
    m_start = np.repeat(ends, cfg.mc_walks_per_end) if n_mc else np.empty(0, np.int64)
    m_first = np.full(n_mc, -1, np.int64)
    m_mode = np.full(n_mc, MODE_MC, np.int64)

    def pad_len(n):
        # bucketed padding: stays a multiple of m (shard divisibility) while
        # bounding distinct compiled walk-batch shapes across datasets
        # (utils/shapes.py; empty section -> no padded ghost scan)
        from telomeri_tpu_torch.utils.shapes import bucket_len

        return bucket_len(n, m)

    gp, mp = pad_len(n_greedy), pad_len(n_mc)
    pad_uid = n_greedy + n_mc

    def section(start, first, mode, uid0, n, w):
        pad = w - n
        nonlocal pad_uid
        uids = np.concatenate([
            np.arange(n, dtype=np.int64) + uid0,
            np.arange(pad, dtype=np.int64) + pad_uid,
        ])
        pad_uid += pad
        return (
            np.concatenate([start, np.zeros(pad, np.int64)]),
            np.concatenate([first, np.full(pad, -1, np.int64)]),
            np.concatenate([mode, np.zeros(pad, np.int64)]),
            uids,
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        )

    gs = section(g_start, g_first, g_mode, 0, n_greedy, gp)
    ms = section(m_start, m_first, m_mode, n_greedy, n_mc, mp)

    cat = lambda i: np.concatenate([gs[i], ms[i]])
    return WalkPlan(
        start=cat(0).astype(np.int32),
        first_edge=cat(1).astype(np.int32),
        mode=cat(2).astype(np.int32),
        uid=cat(3).astype(np.int32),
        active=cat(4),
        sections={"greedy": (0, gp), "mc": (gp, gp + mp)},
    )

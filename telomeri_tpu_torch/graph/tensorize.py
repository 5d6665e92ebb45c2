"""Fixed-shape overlap-graph tensorization: the port of telomeri_tpu/graph/tensorize.py.

EdgeSoA -> a dense (N, K) padded CSR, so that each walk step is one dense row
fetch. GraphTensors and tensorize are the reference's host numpy code, line for
line; the result is host numpy.

Layout:
  - N = 2 * n_seqs oriented nodes (see io/geometry.py for the node encoding), plus
    VIRTUAL overflow nodes for degree-skewed rows (below), padded up to a bucketed row
    count (utils/shapes.py) with unreachable empty rows so the compiled walk program is
    reused across datasets.
  - Row r of each (N, K) table lists node r's out-edges, sorted by (ES desc, dst asc,
    edge-index asc) — the sort IS the greedy tie-break rule (documented, deterministic).
  - The row width K is DATA-DEPENDENT: the observed max out-degree rounded up to a
    multiple of 8, capped at cfg.max_degree (per-step walk gather traffic is O(K), so
    narrower tables are faster).
  - Pad entries have nbr == -1, scores 0, adv 0.
  - Anchor test is id-arithmetic: node v is an anchor iff v < 2 * n_anchors (contigs are
    sequence ids [0, n_anchors)).

Degree skew — hierarchical rows (SURVEY.md §7 "ragged -> fixed shapes"; round-1 verdict
item 3: top-K truncation silently biased MC sampling and could delete the correct bridge
path on real repeat-dense graphs). A node with out-degree d > K keeps its top K-M edges
(by the row sort) in its base row and chains the remaining d-(K-M) edges through M
VIRTUAL child nodes, recursively (capacity grows by ~K per level; NO edge is ever
dropped). Child slots carry:
  nbr = child node id        eid = -2 (hop marker; stripped by scaffold.extract_path)
  adv = 0, es = 0            (a hop adds nothing to path_len / score_sum)
  os  = max subtree OS       (greedy-OS argmax descends toward the global max)
  MC weight = subtree weight sum, so P(leaf edge) = w_leaf / row_total EXACTLY as in a
  flat row (hierarchical inverse-CDF decomposition with integer weights).
Chunks are split in ES order, so base rows stay ES-desc sorted and greedy-ES
(first-valid-slot) still finds the best edge first. Virtual ids live in
[2*n_seqs, 2*n_seqs + n_virtual) — never anchors, never stitched (stripped from paths).
Semantics vs a flat row differ only when a walk REVISITS a hub region: MC's cycle kill
can fire one step later (on the leaf draw), and greedy rerouting compares within one
subtree instead of across the whole row; both are documented, deterministic, and
mirrored exactly by the scalar oracle (it walks the same tensorized rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.io.geometry import EdgeSoA
from telomeri_tpu_torch.utils.shapes import bucket_len


@dataclass
class GraphTensors:
    """Padded-CSR overlap graph (host numpy; device_put by callers).

    nbr/es/os_/adv/eid: (N, K) per-node out-edge tables (see module docstring).
    deg: (N,) int32 occupied base-row slots (= true out-degree for non-hub rows).
    seq_len: (n_seqs,) int32 sequence lengths (for diagnostics; stitching re-reads host seqs).
    n_anchors: number of anchor sequences (contigs).
    """

    nbr: np.ndarray
    es: np.ndarray
    os_: np.ndarray
    adv: np.ndarray
    eid: np.ndarray
    deg: np.ndarray
    seq_len: np.ndarray
    n_anchors: int
    n_truncated_edges: int = 0   # always 0 since round 2 (hierarchical rows)
    stats: dict = field(default_factory=dict)
    # flat per-edge attribute arrays (length n_edges), used by the walk engine to
    # reconstruct path scores/advances post-scan from chosen edge ids (one (W, S)
    # gather instead of per-step (W, K) gathers — see walk/engine.py)
    edge_es: np.ndarray = None
    edge_adv: np.ndarray = None
    # static per-row Monte-Carlo sampling structure (see walk/engine.py mc_weights):
    # cumw[v, j] = sum of integer weights of row v's slots 0..j (row total is the
    # last column; child slots weigh their whole subtree). Static because MC samples
    # the FULL row and kills on revisit (cycle kill), so the per-step distribution
    # never changes.
    cumw: np.ndarray = None      # (N, K) int32
    # (n_seqs,) bool: split-mapped (chimera-suspect) sequences
    # (io/geometry.py split_mapped; consumed by the cut-read gate). None when
    # loaded from a pre-round-4 artifact — the gate then falls back to treating
    # every cut read as suspect (conservative).
    split_read: np.ndarray = None

    @property
    def n_nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    @property
    def virtual_base(self) -> int:
        """Smallest virtual node id; path entries >= this are hierarchy hops."""
        return 2 * len(self.seq_len)

    def anchor_mask(self) -> np.ndarray:
        return np.arange(self.n_nodes, dtype=np.int32) < 2 * self.n_anchors


def tensorize(
    edges: EdgeSoA, seq_len: np.ndarray, n_anchors: int, cfg: ScaffoldConfig
) -> GraphTensors:
    n_seqs = len(seq_len)
    n_nodes = 2 * n_seqs

    # Deterministic row order: (src asc, es desc, dst asc, edge idx asc).
    # np.lexsort is stable; keys listed minor->major.
    e_idx = np.arange(len(edges), dtype=np.int64)
    order = np.lexsort((e_idx, edges.dst, -edges.es.astype(np.float64), edges.src))
    src = edges.src[order].astype(np.int64)

    deg_full = np.bincount(src, minlength=n_nodes)
    # auto-size the row width to the observed degree (multiple of 8 for sublane
    # alignment), capped at cfg.max_degree: per-step walk gather traffic is O(K)
    max_deg = int(deg_full.max()) if n_nodes else 0
    k = min(cfg.max_degree, max(8, -(-max_deg // 8) * 8))
    row_start = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg_full, out=row_start[1:])
    rank = np.arange(len(src), dtype=np.int64) - row_start[src]

    from telomeri_tpu_torch.walk.engine import mc_weights   # engine imports this module

    ew = mc_weights(edges.es).astype(np.int64)   # per-edge MC weights

    # hub rows (degree > k) are built hierarchically below; normal rows vectorized
    is_hub = deg_full > k
    keep = (rank < k) & ~is_hub[src]

    # --- hierarchical rows for hubs (python per hub; hubs are rare) ---
    virt_rows: dict[int, dict] = {}   # vid -> slot dict
    hub_base: dict[int, dict] = {}    # hub node id -> slot dict
    vid_next = n_nodes

    def build_row(sel: np.ndarray) -> dict:
        """Slot arrays for one (possibly hierarchical) row; sel = edge indices in
        (ES desc, dst asc, idx asc) order. Registers virtual child rows."""
        nonlocal vid_next
        if len(sel) <= k:
            return dict(nbr=edges.dst[sel].astype(np.int64), es=edges.es[sel],
                        os=edges.os_[sel], adv=edges.adv[sel].astype(np.int64),
                        eid=sel, w=ew[sel])
        m_child = min(k, -(-(len(sel) - k) // (k - 1)))
        n_real = k - m_child
        real, rest = sel[:n_real], sel[n_real:]
        chunks = np.array_split(rest, m_child)
        c_nbr, c_os, c_w = [], [], []
        for ch in chunks:
            vid = vid_next
            vid_next += 1
            virt_rows[vid] = build_row(ch)
            c_nbr.append(vid)
            c_os.append(float(edges.os_[ch].max()))
            c_w.append(int(ew[ch].sum()))
        return dict(
            nbr=np.concatenate([edges.dst[real].astype(np.int64), c_nbr]),
            es=np.concatenate([edges.es[real],
                               np.zeros(m_child, np.float32)]),     # hops score 0
            os=np.concatenate([edges.os_[real],
                               np.asarray(c_os, np.float32)]),      # subtree max
            adv=np.concatenate([edges.adv[real].astype(np.int64),
                                np.zeros(m_child, np.int64)]),
            eid=np.concatenate([real, np.full(m_child, -2, np.int64)]),
            w=np.concatenate([ew[real], np.asarray(c_w, np.int64)]),
        )

    for h in np.flatnonzero(is_hub):
        hub_base[int(h)] = build_row(order[row_start[h]:row_start[h + 1]])

    n_virtual = vid_next - n_nodes
    n_total = n_nodes + n_virtual

    nbr = np.full((n_total, k), -1, dtype=np.int32)
    es = np.zeros((n_total, k), dtype=np.float32)
    os_ = np.zeros((n_total, k), dtype=np.float32)
    adv = np.zeros((n_total, k), dtype=np.int32)
    eid = np.full((n_total, k), -1, dtype=np.int32)
    w_tab = np.zeros((n_total, k), dtype=np.int64)

    r, c = src[keep], rank[keep]
    sel = order[keep]
    nbr[r, c] = edges.dst[sel]
    es[r, c] = edges.es[sel]
    os_[r, c] = edges.os_[sel]
    adv[r, c] = edges.adv[sel]
    eid[r, c] = sel.astype(np.int32)
    w_tab[r, c] = ew[sel]

    deg = np.minimum(deg_full, k).astype(np.int64)
    for node, row in list(hub_base.items()) + list(virt_rows.items()):
        d = len(row["nbr"])
        nbr[node, :d] = row["nbr"]
        es[node, :d] = row["es"]
        os_[node, :d] = row["os"]
        adv[node, :d] = row["adv"]
        eid[node, :d] = row["eid"]
        w_tab[node, :d] = row["w"]
        if node < n_nodes:
            deg[node] = d
    deg = np.concatenate([
        deg, [(virt_rows[v]["nbr"] >= 0).sum() for v in range(n_nodes, n_total)],
    ]) if n_virtual else deg

    cumw = np.cumsum(w_tab, axis=1, dtype=np.int64)
    if cumw.size and cumw.max() >= np.iinfo(np.int32).max:
        raise ValueError("MC weight cumsum overflows int32; lower max_degree or scores")
    cumw = cumw.astype(np.int32)

    # bucketed node padding (utils/shapes.py): table row counts come from a small
    # geometric family so the compiled walk program is reused across datasets.
    # Padded rows are unreachable (no edge points at them: nbr pads are -1,
    # degrees 0) and sit ABOVE every real+virtual node id, so anchor id-arithmetic
    # and walk-plan enumeration are unaffected.
    n_rows = max(bucket_len(n_total, 8), 8)
    if n_rows > n_total:
        rpad = n_rows - n_total
        pad2 = lambda a, v: np.pad(a, ((0, rpad), (0, 0)), constant_values=v)
        nbr, eid = pad2(nbr, -1), pad2(eid, -1)
        es, os_, adv, cumw = (pad2(a, 0) for a in (es, os_, adv, cumw))
        deg = np.pad(deg, (0, rpad))
    real_deg = deg_full[:n_nodes]
    pos_deg = real_deg[real_deg > 0]
    return GraphTensors(
        nbr=nbr, es=es, os_=os_, adv=adv, eid=eid,
        deg=deg.astype(np.int32),
        seq_len=seq_len.astype(np.int32),
        n_anchors=n_anchors,
        n_truncated_edges=0,
        edge_es=np.asarray(edges.es, np.float32),
        edge_adv=np.asarray(edges.adv, np.int32),
        cumw=cumw,
        stats={
            "n_nodes": n_nodes,
            "n_nodes_padded": n_rows,
            "n_edges": len(edges),
            "max_degree_observed": max_deg,
            # out-degree percentiles over CONNECTED real nodes — the signal for
            # sizing cfg.max_degree (rows above K pay extra hop steps)
            "degree_p50_p90_p99": (
                [int(v) for v in np.percentile(pos_deg, [50, 90, 99])]
                if pos_deg.size else [0, 0, 0]),
            "k": k,
            "n_hub_nodes": int(is_hub.sum()),
            "n_virtual_nodes": n_virtual,
            "n_truncated_edges": 0,
        },
    )

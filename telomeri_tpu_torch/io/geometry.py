"""Directed-edge construction and device rescoring: the port of telomeri_tpu/io/geometry.py.

build_edges is the reference's, line for line, except that its scores come from
this package's numpy oracle (kernels/scoring.py): the reference imports its
scorer from a module that imports jax. The geometry, the filter masks and the
edge layout (EdgeSoA) are imported from the reference, which is jax-free there.
"""

from __future__ import annotations

import numpy as np
import torch

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.io.geometry import (
    EdgeSoA,
    FilterStats,
    malformed_mask,
    overlap_geometry,
)
from telomeri_tpu.io.paf import PafRecords
from telomeri_tpu_torch.kernels.scoring import score_arrays_np, score_overlaps


def build_edges(
    paf: PafRecords, cfg: ScaffoldConfig, n_seqs: int
) -> tuple[EdgeSoA, FilterStats]:
    """Filter PAF rows and emit the two directed edges per kept row (forward
    edge then mirror edge, kept rows in file order). See the reference's
    build_edges for the geometry."""
    if len(paf) and (int(paf.qid.max()) >= n_seqs or int(paf.tid.max()) >= n_seqs
                     or int(paf.qid.min()) < 0 or int(paf.tid.min()) < 0):
        raise ValueError(
            f"PAF sequence ids out of range [0, {n_seqs}) — name_index and "
            f"sequence sets disagree")
    g = overlap_geometry(paf)
    st = FilterStats(n_rows=len(paf))

    self_mask = paf.qid == paf.tid
    si_mask = g["si"] < cfg.min_identity
    mean_ol = (g["ol1"] + g["ol2"]) / 2.0
    short_mask = mean_ol < cfg.min_overlap
    internal_mask = (
        (np.minimum(g["lo_q"], g["lo_t"]) > cfg.max_overhang)
        & (np.minimum(g["ro_q"], g["ro_t"]) > cfg.max_overhang)
    )
    t_contained = (g["lo_t"] <= g["lo_q"]) & (g["ro_t"] <= g["ro_q"])
    q_contained = (g["lo_q"] <= g["lo_t"]) & (g["ro_q"] <= g["ro_t"])
    contained_mask = t_contained | q_contained

    # q is left iff lo_q > lo_t (a tie is containment, already dropped)
    q_left = g["lo_q"] > g["lo_t"]
    oh1 = np.where(q_left, g["ro_q"], g["ro_t"])
    oh2 = np.where(q_left, g["lo_t"], g["lo_q"])
    overhang_mask = (oh1 + oh2) > cfg.max_overhang_ratio * mean_ol

    # each row counts against the FIRST rule that drops it, in the order 0..6
    bad = malformed_mask(paf)
    st.n_malformed = int(bad.sum())
    st.n_self = int((self_mask & ~bad).sum())
    dropped = bad | self_mask
    for name, m in (
        ("n_low_identity", si_mask),
        ("n_short", short_mask),
        ("n_internal", internal_mask),
        ("n_contained", contained_mask),
        ("n_high_overhang", overhang_mask),
    ):
        newly = m & ~dropped
        setattr(st, name, int(newly.sum()))
        dropped |= m
    keep = ~dropped
    st.n_kept = int(keep.sum())

    idx = np.flatnonzero(keep)
    ql, tl = g["ql"][idx], g["tl"][idx]
    qs, qe = g["qs"][idx], g["qe"][idx]
    ts, te = g["ts"][idx], g["te"][idx]
    strand = paf.strand[idx].astype(np.int64)
    q_left = q_left[idx]

    # oriented node ids of the aligned pair: q forward, t in `strand` orientation
    q_node = 2 * paf.qid[idx].astype(np.int64)
    t_node = 2 * paf.tid[idx].astype(np.int64) + strand

    l_node = np.where(q_left, q_node, t_node)
    r_node = np.where(q_left, t_node, q_node)
    l_len = np.where(q_left, ql, tl)
    r_len = np.where(q_left, tl, ql)
    l_s = np.where(q_left, qs, ts)
    l_e = np.where(q_left, qe, te)
    r_s = np.where(q_left, ts, qs)
    r_e = np.where(q_left, te, qe)

    oh1 = l_len - l_e            # left node's unaligned tail
    oh2 = r_s                    # right node's unaligned head
    el1 = l_s - r_s              # left extension
    el2 = (r_len - r_e) - (l_len - l_e)  # right extension
    ol1 = l_e - l_s
    ol2 = r_e - r_s

    nm = paf.nmatch[idx]
    bl = paf.blocklen[idx]
    _, os_, es1, es2 = score_arrays_np(nm, bl, ol1, ol2, oh1, oh2, el1, el2)

    # forward edge L -> R; mirror edge rc(R) -> rc(L), coordinates flipped
    n = len(idx)
    src = np.empty(2 * n, dtype=np.int64)
    dst = np.empty(2 * n, dtype=np.int64)
    es = np.empty(2 * n, dtype=np.float64)
    osb = np.empty(2 * n, dtype=np.float64)
    adv = np.empty(2 * n, dtype=np.int64)
    ue = np.empty(2 * n, dtype=np.int64)
    ve = np.empty(2 * n, dtype=np.int64)
    row = np.empty(2 * n, dtype=np.int64)

    src[0::2], dst[0::2] = l_node, r_node
    es[0::2], osb[0::2], adv[0::2] = es2, os_, el2
    ue[0::2], ve[0::2] = l_e, r_e
    src[1::2], dst[1::2] = r_node ^ 1, l_node ^ 1
    es[1::2], osb[1::2], adv[1::2] = es1, os_, el1
    ue[1::2], ve[1::2] = r_len - r_s, l_len - l_s
    row[0::2] = row[1::2] = idx

    def interleave(fwd, mir):
        out = np.empty(2 * n, dtype=np.int32)
        out[0::2], out[1::2] = fwd, mir
        return out

    edges = EdgeSoA(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        os_=osb.astype(np.float32), es=es.astype(np.float32),
        adv=adv.astype(np.int32), ue=ue.astype(np.int32), ve=ve.astype(np.int32),
        row=row.astype(np.int32),
        nm=interleave(nm, nm), bl=interleave(bl, bl),
        ol1=interleave(ol1, ol1), ol2=interleave(ol2, ol2),
        oh1=interleave(oh1, oh1), oh2=interleave(oh2, oh2),
        el=interleave(el2, el1),
    )
    return edges, st


def rescore_edges_device(edges: EdgeSoA, device) -> EdgeSoA:
    """Recompute edges.os_ / edges.es on `device` with the 2-output scorer (the
    hand-written kernel on a card, the plain torch version on CPU tensors); the
    device result replaces the host scores, so one backend scores the run."""
    if len(edges) == 0:
        return edges
    geom = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in edges.geom_args()]
    os_, es2 = score_overlaps(*geom, outputs=2)
    edges.os_ = os_.cpu().numpy()
    edges.es = es2.cpu().numpy()
    return edges

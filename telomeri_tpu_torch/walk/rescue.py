"""Rescue rounds: the port of telomeri_tpu/walk/rescue.py.

After conflict resolution, still-free walkable contig ends are re-walked at
rescue_walks_per_end MC walks each through the SAME grouping and cut-read gate
as the base round (read_diverse support); rescue bridges are conflict-resolved
INTO the accepted set, so a round only adds bridges on free ends. On one device
or, given a mesh, sharded over its ranks in either graph placement (dist/).
free_walkable_ends and build_rescue_plan are copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.scaffold.bridge import Bridge, resolve_with_blockers
from telomeri_tpu_torch.scaffold.stitch import extract_path
from telomeri_tpu_torch.utils.logging import log
from telomeri_tpu_torch.walk.plan import MODE_MC, WalkPlan
from telomeri_tpu_torch.consensus.evidence import read_diversity_gate
from telomeri_tpu_torch.consensus.grouping import compress, walk_consensus
from telomeri_tpu_torch.dist.mesh import (
    WalkMesh,
    fetch_walk_rows,
    gathered_consensus,
    run_walk_shards,
)
from telomeri_tpu_torch.kernels.walk_table import GraphDev, graph_to_device
from telomeri_tpu_torch.walk.engine import count_steps_taken, run_walks_sectioned

RESCUE_UID_BASE = 1 << 30   # rescue uids never collide with base plan uids
MAX_RESCUE_WALKS = 1 << 20  # hard batch cap: many free ends -> fewer walks/end


def free_walkable_ends(graph: GraphTensors, accepted: list[Bridge],
                       blocked_ends=frozenset()) -> list[int]:
    """Oriented start nodes of contig ends that are not used by an accepted
    bridge, not claimed by a cut-read blocker, and walkable (out-degree > 0)."""
    used = {(b.end_a.contig, b.end_a.right) for b in accepted}
    used |= {(b.end_b.contig, b.end_b.right) for b in accepted}
    used |= {(e.contig, e.right) for e in blocked_ends}
    deg = np.asarray(graph.deg)
    out = []
    for c in range(graph.n_anchors):
        for right, u in ((True, 2 * c), (False, 2 * c + 1)):
            if (c, right) not in used and deg[u] > 0:
                out.append(u)
    return out


def build_rescue_plan(ends: list[int], cfg: ScaffoldConfig, round_ix: int = 0,
                      mesh_size: int = 1) -> tuple[WalkPlan, int]:
    """All-MC WalkPlan for one rescue round, the batch capped at
    MAX_RESCUE_WALKS (the end list is truncated when even one walk per end
    would exceed it) and padded to divide over mesh_size ranks. Returns
    (plan, uid0); uids are uid0 + row."""
    if len(ends) > MAX_RESCUE_WALKS:
        log.warning(
            "rescue round %d: %d free ends exceed the %d-walk budget; walking "
            "the first %d ends this round (rest deferred to later rounds)",
            round_ix, len(ends), MAX_RESCUE_WALKS, MAX_RESCUE_WALKS)
        ends = ends[:MAX_RESCUE_WALKS]
    per_end = max(1, min(cfg.rescue_walks_per_end, MAX_RESCUE_WALKS // len(ends)))
    starts = np.repeat(np.array(ends, np.int32), per_end)
    n_pad = -len(starts) % (cfg.walk_batch_multiple * max(mesh_size, 1))
    active = np.concatenate([np.ones(len(starts), bool), np.zeros(n_pad, bool)])
    starts = np.concatenate([starts, np.zeros(n_pad, np.int32)])
    w = len(starts)
    if w >= 1 << 24:
        raise ValueError(f"rescue batch {w} overflows its uid block")
    uid0 = RESCUE_UID_BASE + round_ix * (1 << 24)
    plan = WalkPlan(
        start=starts, first_edge=np.full(w, -1, np.int32),
        mode=np.full(w, MODE_MC, np.int32),
        uid=(uid0 + np.arange(w)).astype(np.int32),
        active=active, sections={"greedy": (0, 0), "mc": (0, w)})
    return plan, uid0


def run_rescue_round(
    graph: GraphTensors, cfg: ScaffoldConfig, accepted: list[Bridge],
    round_ix: int = 0, gd: GraphDev | None = None, blocked_ends=frozenset(),
    *, device=None, mesh: WalkMesh | None = None, placement: str = "replicated",
):
    """One rescue round on `device` or, given a mesh, on its ranks (placement
    "rowshard" runs the row-sharded walks; gd is the replicated table).
    Returns (new_bridges, paths, blocked_ends'): paths maps each new bridge's
    rep_uid to its WalkPath for the stitcher; ([], {}, blocked_ends) when
    nothing qualified."""
    ends = free_walkable_ends(graph, accepted, blocked_ends)
    if not ends or cfg.rescue_walks_per_end == 0:
        return [], {}, blocked_ends
    plan, uid0 = build_rescue_plan(ends, cfg, round_ix,
                                   mesh_size=mesh.size if mesh is not None else 1)
    # the same grouping and evidence rules as the base round, read_diverse always
    if mesh is not None:
        if placement == "rowshard":
            from telomeri_tpu_torch.dist.rowshard import run_walks_rowsharded

            res = run_walks_rowsharded(graph, plan, cfg.mc_seed, max_steps=cfg.max_steps,
                                       mesh=mesh)
        else:
            if gd is None:
                gd = graph_to_device(graph, mesh.device)
            res = run_walk_shards(gd, plan, cfg.mc_seed, n_anchors=graph.n_anchors,
                                  max_steps=cfg.max_steps, mesh=mesh)
        cons = gathered_consensus(res, plan, mesh, cfg, virtual_base=graph.virtual_base,
                                  support="read_diverse")
    else:
        if gd is None:
            gd = graph_to_device(graph, device)
        res = run_walks_sectioned(gd, plan, cfg.mc_seed, n_anchors=graph.n_anchors,
                                  max_steps=cfg.max_steps)
        cons = walk_consensus(res, torch.from_numpy(plan.uid), cfg,
                              virtual_base=graph.virtual_base, support="read_diverse")
        res = res.to_numpy()
    count_steps_taken(res)
    rows, blocked_rows = read_diversity_gate(
        compress(cons), cons, res, graph.virtual_base, mesh=mesh,
        split_read=graph.split_read)
    new, blocked_ends = resolve_with_blockers(
        rows, blocked_rows, pre_accepted=accepted, pre_blocked=blocked_ends)
    if not new:
        return [], {}, blocked_ends
    rowids = np.array([b.rep_uid - uid0 for b in new], np.int64)   # uids are row-aligned
    if mesh is not None:
        res = fetch_walk_rows(res, rowids, mesh)
        rowids = np.arange(len(new))
    paths = {}
    for b, i in zip(new, rowids):
        paths[b.rep_uid] = extract_path(res.nodes[i], res.eids[i], int(res.steps[i]),
                                        virtual_base=graph.virtual_base)
    return new, paths, blocked_ends

"""Row-sharded walk tables: the port of telomeri_tpu/dist/rowshard.py.

For graphs whose packed walk table does not fit one device (pipeline.py
_resolve_placement), rank i holds rows [i*N/D, (i+1)*N/D) of the (N, 6H) int32
table, padded to a multiple of the world size with dead rows (nbr and eid -1,
cum 0, so the row total is 0), and every walk step fetches its rows from their
owners with two collectives:

    cur_all = all_gather(cur_local)                        # (W,) int32
    part    = where(owned, table_local[cur_all - off], 0)  # masked local gather
    rows    = reduce_scatter(part, SUM)                    # (W/D, 6H) back to owner

Exactly one rank contributes a nonzero row per walk, and the table is int32
throughout (ES and OS as float32 bits), so the integer sum is exact and the
records are bit-equal to the replicated run. Every rank runs every section for
every step, so the collectives stay in lockstep even where a rank's block of a
section has no active walk.

The walks run through the engine's row-fetch-parameterised scans, in their
PLAIN versions with the collective fetch: _kind_core for greedy and mixed
sections (kernels/greedy_scan.py greedy_scan_torch) and, for the MC section,
kernels/walk_scan.py walk_scan_torch. This is the reference's own design (it
runs _mc_fast_core and _kind_core here, not its Pallas scan): the CUDA scan
kernels read rows straight from one device's table, which is what this
placement does not have, so the row-sharded scans never launch them. The MC
records then lie on the rank's device, and resolve_mc_events (with the GLOBAL
row count) resolves them there: on a card, its kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.walk.plan import WalkPlan
from telomeri_tpu_torch.dist.mesh import ShardedWalks, WalkMesh, shard_plan
from telomeri_tpu_torch.kernels.walk_scan import walk_scan_torch
from telomeri_tpu_torch.walk.engine import (
    GraphDev,
    WalkResult,
    _cum_arrays,
    _empty_result,
    _kind_core,
    count_dispatch,
    lane_width,
    pack_wide,
    prepare_plan_sections,
    resolve_mc_events,
    stable_bits_table,
)
from telomeri_tpu_torch.utils.profiling import span


def shard_graph_rows(g: GraphTensors, mesh: WalkMesh) -> GraphDev:
    """This rank's rows of the packed table, padded with dead rows so that the
    row count divides the world size."""
    h = lane_width(g.nbr.shape[1])
    wide = pack_wide(g.nbr, _cum_arrays(g), g.eid, g.adv, g.es, g.os_, h)
    n_pad = -wide.shape[0] % mesh.size
    if n_pad:
        pad = np.zeros((n_pad, wide.shape[1]), np.int32)
        pad[:, :h] = -1           # nbr
        pad[:, 2 * h:3 * h] = -1  # eid
        wide = np.concatenate([wide, pad], axis=0)
    per = wide.shape[0] // mesh.size
    mine = np.ascontiguousarray(wide[mesh.rank * per:(mesh.rank + 1) * per])
    return GraphDev(wide=torch.from_numpy(mine).to(mesh.device))


def _collective_fetch(table: torch.Tensor, mesh: WalkMesh):
    """fetch(cur_local) -> (W_local, 6H) rows of this rank's walks, gathered
    from the ranks that own them."""
    rows_per = table.shape[0]
    off = mesh.rank * rows_per
    zero = torch.zeros((), dtype=table.dtype, device=table.device)

    def fetch(cur: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(cur) for _ in range(mesh.size)]
        dist.all_gather(parts, cur.contiguous(), group=mesh.group)
        loc = torch.cat(parts).long() - off
        owned = (loc >= 0) & (loc < rows_per)
        part = torch.where(owned[:, None], table[loc.clamp(0, rows_per - 1)], zero)
        out = torch.empty((cur.shape[0], table.shape[1]), dtype=table.dtype,
                          device=table.device)
        dist.reduce_scatter(out, list(part.chunk(mesh.size)), op=dist.ReduceOp.SUM,
                            group=mesh.group)
        return out

    return fetch


def run_walks_rowsharded(g: GraphTensors, plan: WalkPlan, seed, *, max_steps: int,
                         mesh: WalkMesh) -> ShardedWalks:
    """Sectioned walks over a row-sharded table; each rank runs its block of
    every section (as in dist/mesh.py) and keeps its records. Bit-equal to the
    replicated run on the same plan."""
    n_nodes = g.nbr.shape[0]   # GLOBAL: picks resolve_mc_events' revisit branch
    shard = shard_graph_rows(g, mesh)
    local, rows = shard_plan(plan, mesh)
    fetch = _collective_fetch(shard.wide, mesh)
    parts = []
    sections = prepare_plan_sections(local, mesh.device)
    d, w = count_dispatch(sections, max_steps)
    with span("walk.dispatch", dispatch=d, W=w, S=max_steps):
        for kind, pd in sections:
            with span("walk.section", kind=kind):
                if kind == "mc":
                    bits = stable_bits_table(seed, pd.uid, max_steps)
                    recs = walk_scan_torch(shard.wide, pd.start, bits, max_steps, fetch=fetch)
                    parts.append(resolve_mc_events(pd, *recs, n_nodes=n_nodes,
                                                   n_anchors=g.n_anchors, max_steps=max_steps))
                else:
                    parts.append(_kind_core(shard, pd, seed, n_anchors=g.n_anchors,
                                            max_steps=max_steps, kind=kind, fetch=fetch))
    if not parts:
        res = _empty_result(max_steps, mesh.device)
    elif len(parts) == 1:
        res = parts[0]
    else:
        res = WalkResult(*[torch.cat(a, dim=0) for a in zip(*parts)])
    return ShardedWalks(local=res, rows=rows, n_rows=len(plan))

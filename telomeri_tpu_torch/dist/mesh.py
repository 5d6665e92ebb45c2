"""Walks sharded over several devices with torch.distributed: the port of telomeri_tpu/dist/mesh.py.

One process per device, launched by torchrun (`torchrun --nproc-per-node N -m
telomeri_tpu_torch.cli.main scaffold --mesh N ...`) or by the CLI itself, which
starts the N ranks when `--mesh N` finds no launcher. A WalkMesh takes the place
of the reference's 1-D jax.sharding.Mesh: the process group, this process's
rank, the world size, the rank on its host and the device. NCCL joins CUDA
devices, gloo CPU processes.

The decomposition is the reference's: the graph is REPLICATED on every rank;
each plan section is split into contiguous, equal blocks, one per rank, and
every rank runs its block of every section through the single-device engine
(walk/engine.py run_walks_sectioned, so the CUDA walk-scan kernel runs on each
rank's MC block). The per-walk summaries are all-gathered, put back into plan
row order, and group_and_select runs on every rank: the same consensus
everywhere, equal to the single-device run, since walk uids, not ranks, seed
the draws and break the ties.

The records stay on their ranks (ShardedWalks). A rank holds its block of each
section, so its rows are not one slice of the plan: with two ranks and sections
[greedy | mc], rank 0 holds greedy block 0 and mc block 0. Gathered rows are put
back as [greedy blocks 0..D-1, mc blocks 0..D-1] before anything reads them by
plan row; fetch_walk_rows brings chosen rows to every rank as host numpy.

Every rank must make the same collective calls in the same order, so every
branch that leads to one depends only on replicated values (the plan, the
consensus), never on a rank's own rows.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.walk.plan import WalkPlan
from telomeri_tpu_torch.consensus.grouping import ConsensusResult, WalkSummary, walk_consensus
from telomeri_tpu_torch.utils.profiling import span
from telomeri_tpu_torch.kernels.walk_table import GraphDev, graph_to_device
from telomeri_tpu_torch.walk.engine import WalkResult, run_walks_sectioned


class WalkMesh(NamedTuple):
    """One process per device; the walks are sharded over the world."""

    group: object            # torch.distributed process group
    rank: int
    size: int
    local_rank: int          # rank on this host: 0 writes the host's output files
    device: torch.device


class ShardedWalks(NamedTuple):
    """Walk records left on their ranks."""

    local: WalkResult        # this rank's rows, tensors on the rank's device
    rows: np.ndarray         # (w_local,) int64: the plan row of each local row
    n_rows: int              # rows in the whole plan


def init_distributed(device="cuda", *, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> None:
    """Join the process group of this run (NCCL for "cuda", gloo for "cpu").

    With init_method (and rank, world_size) it joins exactly as asked. Under
    torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT, it reads them. With neither, the world is this one process.
    A no-op when a group exists already."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    kw = {"backend": "gloo"}
    if device.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        # device_id creates the NCCL communicator here, not inside the first
        # collective, i.e. the walk stage
        kw = {"backend": "nccl", "device_id": local}
    if init_method is not None:
        dist.init_process_group(init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_walk_mesh(n_devices: int | None = None, device="cuda") -> WalkMesh:
    """The mesh of the whole world (init_distributed first). n_devices must
    equal the world size: each device is one process, so a mesh of N needs N
    processes from the launcher."""
    if not dist.is_initialized():
        raise RuntimeError("make_walk_mesh: call init_distributed() first")
    size, rank = dist.get_world_size(), dist.get_rank()
    n = size if n_devices is None else n_devices
    if n != size:
        raise ValueError(
            f"a mesh of {n} devices runs one process per device, but this world "
            f"has {size}: launch `torchrun --nproc-per-node {n} -m "
            f"telomeri_tpu_torch.cli.main scaffold --mesh {n} ...`")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
    return WalkMesh(group=dist.group.WORLD, rank=rank, size=size,
                    local_rank=local_rank, device=device)


def spans_hosts(mesh: WalkMesh) -> bool:
    """True where the world has ranks on another host: more ranks than this
    host runs (the launcher's LOCAL_WORLD_SIZE; a world joined without a
    launcher is taken to be on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", mesh.size)) < mesh.size


# --- plan layout -------------------------------------------------------------------

def _blocks(plan: WalkPlan, size: int) -> list[tuple[str, int, int]]:
    """(kind, first row, rows per rank) of each non-empty plan section, in the
    engine's order (greedy, then mc; one "mixed" block for an unsectioned plan).
    Raises ValueError where a section does not divide over the ranks."""
    if len(plan) % size:
        raise ValueError(f"walk batch {len(plan)} not divisible by mesh size {size}")
    if plan.sections is None:
        return [("mixed", 0, len(plan) // size)] if len(plan) else []
    out = []
    for kind in ("greedy", "mc"):
        lo, hi = plan.sections[kind]
        if hi <= lo:
            continue
        if (hi - lo) % size:
            raise ValueError(
                f"plan section {kind!r} ({hi - lo} walks) not divisible by mesh "
                f"size {size}; re-run plan_walks(n_shards={size})")
        out.append((kind, lo, (hi - lo) // size))
    return out


def shard_plan(plan: WalkPlan, mesh: WalkMesh) -> tuple[WalkPlan, np.ndarray]:
    """This rank's block of every section, as a plan of its own with the same
    sections, and the plan row of each of its rows."""
    blocks = _blocks(plan, mesh.size)
    rows = np.concatenate([lo + mesh.rank * b + np.arange(b, dtype=np.int64)
                           for _, lo, b in blocks] or [np.zeros(0, np.int64)])
    sections = None
    if plan.sections is not None:
        sections, off = {"greedy": (0, 0), "mc": (0, 0)}, 0
        for kind, _, b in blocks:
            sections[kind] = (off, off + b)
            off += b
    local = WalkPlan(start=plan.start[rows], first_edge=plan.first_edge[rows],
                     mode=plan.mode[rows], uid=plan.uid[rows],
                     active=plan.active[rows], sections=sections)
    return local, rows


def _all_gather(x: torch.Tensor, mesh: WalkMesh) -> list[torch.Tensor]:
    with span("mesh.gather", rows=x.shape[0], ranks=mesh.size):
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return parts


def _plan_order(parts: list[torch.Tensor], blocks) -> torch.Tensor:
    """Rows gathered from every rank (each [its block of each section]) ->
    plan row order [section 0 blocks 0..D-1, section 1 blocks 0..D-1]."""
    out, off = [], 0
    for _, _, b in blocks:
        out += [p[off:off + b] for p in parts]
        off += b
    return torch.cat(out)


# --- walks and consensus ------------------------------------------------------------

def run_walk_shards(gd: GraphDev, plan: WalkPlan, seed, *, n_anchors: int,
                    max_steps: int, mesh: WalkMesh) -> ShardedWalks:
    """This rank's block of every section on the replicated table `gd`."""
    local, rows = shard_plan(plan, mesh)
    res = run_walks_sectioned(gd, local, seed, n_anchors=n_anchors, max_steps=max_steps)
    return ShardedWalks(local=res, rows=rows, n_rows=len(plan))


def gather_summary(s: WalkSummary, plan: WalkPlan, mesh: WalkMesh) -> WalkSummary:
    """All-gather the ranks' per-walk summaries into plan row order (the
    reference's candidate-path merge). One int64 all_gather; score_sum travels
    as its float32 bits."""
    blocks = _blocks(plan, mesh.size)
    if not blocks:   # no walks on any rank
        return s
    cols = [s.start, s.terminal, s.success, s.path_len,
            s.score_sum.view(torch.int32), s.uid]
    if s.sig is not None:
        cols.append(s.sig)
    full = _plan_order(_all_gather(torch.stack([c.to(torch.int64) for c in cols], 1),
                                   mesh), blocks)
    i32 = lambda j: full[:, j].to(torch.int32)
    return WalkSummary(start=i32(0), terminal=i32(1), success=full[:, 2] != 0,
                       path_len=i32(3), score_sum=i32(4).view(torch.float32),
                       uid=i32(5), sig=full[:, 6] if s.sig is not None else None)


def gathered_consensus(walks: ShardedWalks, plan: WalkPlan, mesh: WalkMesh,
                       cfg: ScaffoldConfig, *, virtual_base, support: str) -> ConsensusResult:
    """summarize on each rank, gather, group_and_select on every rank; host numpy."""
    return walk_consensus(walks.local, torch.from_numpy(plan.uid[walks.rows]), cfg,
                          virtual_base=virtual_base, support=support,
                          gather=lambda s: gather_summary(s, plan, mesh))


def run_walks_distributed(g: GraphTensors, plan: WalkPlan, cfg: ScaffoldConfig,
                          mesh: WalkMesh) -> tuple[ShardedWalks, ConsensusResult]:
    """Sharded walks + gathered consensus. Returns (the records, left on their
    ranks; the consensus as host numpy, the same on every rank).
    cfg.graph_placement == "rowshard" shards the table's rows over the ranks
    instead of replicating it (dist/rowshard.py); the results are the same."""
    if not isinstance(plan, WalkPlan):
        raise TypeError("run_walks_distributed expects a host WalkPlan")
    if cfg.graph_placement == "rowshard":
        from telomeri_tpu_torch.dist.rowshard import run_walks_rowsharded

        walks = run_walks_rowsharded(g, plan, cfg.mc_seed, max_steps=cfg.max_steps,
                                     mesh=mesh)
    else:
        walks = run_walk_shards(graph_to_device(g, mesh.device), plan, cfg.mc_seed,
                                n_anchors=g.n_anchors, max_steps=cfg.max_steps, mesh=mesh)
    cons = gathered_consensus(walks, plan, mesh, cfg, virtual_base=g.virtual_base,
                              support=cfg.support_mode)
    return walks, cons


# --- records -------------------------------------------------------------------------

def _pack_records(r: WalkResult) -> torch.Tensor:
    """(W, 2S+6) int32: nodes | eids | steps | success | terminal | path_len | score_sum bits."""
    col = lambda a: a.to(torch.int32)[:, None]
    return torch.cat([r.nodes, r.eids, col(r.steps), col(r.success), col(r.terminal),
                      col(r.path_len), r.score_sum.view(torch.int32)[:, None]], dim=1)


def _unpack_records(p: np.ndarray) -> WalkResult:
    s = (p.shape[1] - 6) // 2
    return WalkResult(nodes=p[:, :s + 1].copy(), eids=p[:, s + 1:2 * s + 1].copy(),
                      steps=p[:, 2 * s + 1].copy(), success=p[:, 2 * s + 2] != 0,
                      terminal=p[:, 2 * s + 3].copy(), path_len=p[:, 2 * s + 4].copy(),
                      score_sum=p[:, 2 * s + 5].copy().view(np.float32))


def fetch_walk_rows(walks: ShardedWalks, rows, mesh: WalkMesh) -> WalkResult:
    """The records of the given plan rows, as host numpy on every rank.

    Each rank fills the rows it owns into a zeroed (R, 2S+6) int32 buffer and
    one all_reduce(SUM) completes it: exactly one rank owns each row, so the
    integer sum is exact (score_sum travels as bits)."""
    rows = np.asarray(rows, np.int64)
    pos = np.full(walks.n_rows, -1, np.int64)
    pos[walks.rows] = np.arange(len(walks.rows))
    loc = pos[rows]
    mine = np.flatnonzero(loc >= 0)
    packed = _pack_records(walks.local)
    buf = torch.zeros((len(rows), packed.shape[1]), dtype=torch.int32,
                      device=packed.device)
    if len(rows):
        dev = packed.device
        buf[torch.from_numpy(mine).to(dev)] = packed[torch.from_numpy(loc[mine]).to(dev)]
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return _unpack_records(buf.cpu().numpy())


def count_walks(walks: ShardedWalks, max_steps: int, mesh: WalkMesh) -> tuple[int, int]:
    """(successful, truncated at max_steps) walks over all ranks."""
    r = walks.local
    c = torch.stack([r.success.sum(), ((r.steps >= max_steps) & ~r.success).sum()])
    c = c.to(torch.int64)
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=mesh.group)
    return int(c[0]), int(c[1])

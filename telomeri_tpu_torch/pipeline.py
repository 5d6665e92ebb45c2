"""End-to-end scaffolding pipeline: the port of telomeri_tpu/pipeline.py.

host ingest -> build_edges -> [device] optional rescoring -> tensorize ->
plan_walks -> [device] walks -> [device] consensus -> [host] cut-read gate and
coherence -> conflict resolution -> [device] rescue rounds -> stitching ->
FASTA. The stages, their metrics and the artifacts that resume a run at a stage
boundary (--graph / --walks) are the reference's; the device work runs in torch
on `device` ("cuda" launches the hand-written kernels, "cpu" runs their plain
versions). Host stages receive host numpy arrays.

With a mesh (dist/mesh.py: one process per device under torchrun) the walks
and the rescue rounds shard over the ranks, with the graph replicated or, for
tables beyond ~75% of one device's memory, row-sharded (_resolve_placement); the
scaffolds are the same as on one device. Each host writes its output files
once, from local rank 0.

The score, walk and rescue dispatches are timed by DispatchWatch
(utils/watchdog.py) under the reference's keys, so metrics.json carries the
same "dispatches" record; on a card each watched body
synchronizes the device before the record closes. Each stage is a span of the
profiler's trace (`trace_dir`: the whole run), and metrics.json carries the
program's counters that the run added (utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.io.fasta import SequenceSet, read_fasta, write_fasta
from telomeri_tpu_torch.io.geometry import EdgeSoA, split_evidence_mask, split_mapped
from telomeri_tpu_torch.io.paf import PafRecords, parse_paf
from telomeri_tpu_torch.scaffold.bridge import resolve_with_blockers
from telomeri_tpu_torch.scaffold.stitch import Scaffold, Stitcher, emit_scaffolds, extract_path
from telomeri_tpu_torch.utils.logging import Metrics, log
from telomeri_tpu_torch.utils.watchdog import DispatchWatch
from telomeri_tpu_torch.walk.plan import WalkPlan, plan_walks
from telomeri_tpu_torch.consensus.evidence import read_diversity_gate
from telomeri_tpu_torch.consensus.grouping import (
    compress,
    summarize,
    summarize_in_chunks,
    summary_consensus,
)
from telomeri_tpu_torch.dist.mesh import (
    ShardedWalks,
    WalkMesh,
    count_walks,
    fetch_walk_rows,
    run_walks_distributed,
    spans_hosts,
)
from telomeri_tpu_torch.graph.tensorize import tensorize
from telomeri_tpu_torch.io.artifacts import load_graph, load_walks, save_graph, save_walks
from telomeri_tpu_torch.io.geometry import build_edges, rescore_edges_device
from telomeri_tpu_torch.utils.profiling import (count_copy, counters, counters_since,
                                                maybe_trace, span)
from telomeri_tpu_torch.walk import engine
from telomeri_tpu_torch.kernels import walk_table
from telomeri_tpu_torch.walk.engine import WalkResult, run_walks_host
from telomeri_tpu_torch.walk.rescue import free_walkable_ends, run_rescue_round

# "auto" device scoring engages at this many edges on a CUDA device. This is the
# reference's TPU cutover: build_edges scores every edge on the host anyway, so
# the rescore adds to a run at any size and the H100's measured crossover
# applies only once build_edges leaves scoring to the device (ROADMAP.md).
AUTO_SCORING_MIN_EDGES = 32_000_000


def _pow2_bucket(n: int) -> int:
    """Dispatch-history key bucket (the reference's): the next power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


@contextmanager
def _watch(metrics: Metrics, key: str, device: torch.device):
    """One dispatch record under the reference's key; the device's work is
    finished before the record closes."""
    with DispatchWatch(metrics).watch(key):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


@dataclass
class PipelineResult:
    scaffolds: list[Scaffold]
    graph: GraphTensors
    edges: EdgeSoA
    plan: WalkPlan
    walks: WalkResult | ShardedWalks   # host numpy, or left on the mesh's ranks
    bridges: list[dict]
    accepted: list
    metrics: Metrics


def load_inputs(contigs_path: str, reads_path: str, paf_rc_path, paf_rr_path,
                metrics: Metrics | None = None, lazy: str = "auto"):
    """Host ingest: sequences + name table + concatenated PAF rows (one path or
    a list of paths each; rows keep file-then-line order)."""
    as_list = lambda p: [p] if isinstance(p, (str, bytes, os.PathLike)) else list(p)
    metrics = metrics or Metrics()
    with metrics.stage("load_sequences"):
        contigs = read_fasta(contigs_path, lazy=lazy)
        reads = read_fasta(reads_path, lazy=lazy)
    name_index = {n: i for i, n in enumerate(contigs.names)}
    for i, n in enumerate(reads.names):
        if n in name_index:
            raise ValueError(f"read name {n!r} collides with a contig name")
        name_index[n] = len(contigs) + i
    with metrics.stage("parse_paf"):
        paf = PafRecords.concatenate(
            [parse_paf(p, name_index) for p in as_list(paf_rc_path)]
            + [parse_paf(p, name_index) for p in as_list(paf_rr_path)])
    from telomeri_tpu_torch.native.paf_native import available as _native_ok

    backend = "native" if _native_ok() else "python"
    metrics.set("parser_backend", backend)
    if backend == "python":
        log.info("native parser library not built (python -m "
                 "telomeri_tpu_torch.native.build); using the Python parsers")
    return contigs, reads, paf


def build_graph(contigs: SequenceSet, reads: SequenceSet, paf: PafRecords,
                cfg: ScaffoldConfig, metrics: Metrics | None = None, *, device):
    """Edges (optionally rescored on `device`) and the tensorized graph."""
    metrics = metrics or Metrics()
    device = torch.device(device)
    n_seqs = len(contigs) + len(reads)
    with metrics.stage("build_edges"):
        edges, fstats = build_edges(paf, cfg, n_seqs)
    metrics.set("filter", fstats.as_dict())
    if cfg.device_scoring != "off":
        on_card = device.type == "cuda"
        want = cfg.device_scoring == "on" or (
            on_card and len(edges) >= AUTO_SCORING_MIN_EDGES)
        backend = ("cuda" if on_card else "torch") if want else "numpy"
        if want:
            with metrics.stage("score_edges_device"), \
                    _watch(metrics, f"score_edges:{_pow2_bucket(len(edges))}", device):
                edges = rescore_edges_device(edges, device)
        metrics.set("scoring_backend", backend)
    with metrics.stage("tensorize"):
        seq_len = np.concatenate([
            contigs.lengths, reads.lengths]) if n_seqs else np.empty(0, np.int64)
        graph = tensorize(edges, seq_len, len(contigs), cfg)
        if cfg.split_read_margin > 0:
            graph.split_read = split_mapped(
                paf, n_seqs, min_overlap=cfg.split_read_margin,
                row_mask=split_evidence_mask(paf, cfg.min_identity))
            metrics.set("n_split_reads", int(graph.split_read.sum()))
    metrics.set("graph", graph.stats)
    return edges, graph


def _device_memory_limit(device: torch.device) -> int | None:
    """Bytes of memory on `device`, or None where torch knows no limit (CPU)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return None


def _resolve_placement(cfg: ScaffoldConfig, graph: GraphTensors, mesh: WalkMesh | None,
                       metrics: Metrics) -> ScaffoldConfig:
    """graph_placement="auto": replicated unless the walk stage's tables on
    one device (walk_table.device_walk_bytes: the packed table, and on a card the
    MC kernel's pick plane each replicated rank builds beside it) exceed ~75%
    of its memory (16 GiB where torch knows no limit) and the mesh has more
    than one device; then row-sharded (dist/rowshard.py), which builds no
    plane. Returns the cfg to run walks with."""
    if cfg.graph_placement != "auto":
        return cfg
    placement = "replicated"
    if mesh is not None and mesh.size > 1:
        need = walk_table.device_walk_bytes(graph, mesh.device)
        limit = _device_memory_limit(mesh.device)
        budget = 0.75 * (limit if limit else 16 * 2**30)
        if need > budget:
            placement = "rowshard"
            log.info(
                "graph tables %.1f GiB exceed 75%% of device memory "
                "(%.1f GiB budget): row-sharding over the %d-device mesh",
                need / 2**30, budget / 2**30, mesh.size)
    metrics.set("graph_placement", placement)
    return dataclasses.replace(cfg, graph_placement=placement)


def _consensus(walks: WalkResult, plan: WalkPlan, graph: GraphTensors,
               cfg: ScaffoldConfig, device):
    """Consensus of records on `device`, or of host records, uploaded there: all
    at once, or, for a plan that ran in chunks (above cfg.max_walk_batch rows),
    chunk by chunk, so that the consensus keeps the bound on device memory
    that the chunked walk stage kept."""
    walks = WalkResult(*[torch.as_tensor(a) for a in walks])
    uid = torch.from_numpy(plan.uid)
    if walks.nodes.device.type == "cpu" and 0 < cfg.max_walk_batch < len(plan):
        summary = summarize_in_chunks(walks, uid, graph.virtual_base, cfg.max_walk_batch, device)
    else:
        with span("consensus.upload", W=len(plan)):
            rec = walks.to(device)
        count_copy(rec, walks.nodes.device, device)
        summary = summarize(rec, uid, virtual_base=graph.virtual_base)
    return summary_consensus(summary, cfg, cfg.support_mode)


def run_pipeline(
    contigs_path: str,
    reads_path: str,
    paf_rc_path: str | list[str] | None,
    paf_rr_path: str | list[str] | None,
    out_path: str | None,
    cfg: ScaffoldConfig = ScaffoldConfig(),
    metrics: Metrics | None = None,
    mesh: WalkMesh | None = None,
    graph_artifact: str | None = None,
    save_graph_path: str | None = None,
    walks_artifact: str | None = None,
    save_walks_path: str | None = None,
    trace_dir: str | None = None,
    agp_path: str | None = None,
    *,
    device="cuda",
) -> PipelineResult:
    """Full pipeline (the reference's arguments, plus `device`). Pass a
    WalkMesh (dist/mesh.py) to shard the walks over its ranks; its device then
    takes the place of `device`. graph / walks artifacts resume the pipeline
    from a stage boundary; trace_dir (or $TELOMERI_TRACE) writes a profiler
    trace of the whole run. metrics.counters receives what the program's
    counters added during the run."""
    metrics = metrics or Metrics()
    before = counters()
    with maybe_trace(trace_dir):
        res = _run(contigs_path, reads_path, paf_rc_path, paf_rr_path, out_path, cfg, metrics,
                   mesh, graph_artifact, save_graph_path, walks_artifact, save_walks_path,
                   agp_path, device)
    metrics.counters = counters_since(before)
    return res


def _run(contigs_path, reads_path, paf_rc_path, paf_rr_path, out_path, cfg: ScaffoldConfig,
         metrics: Metrics, mesh: WalkMesh | None, graph_artifact, save_graph_path,
         walks_artifact, save_walks_path, agp_path, device) -> PipelineResult:
    """run_pipeline's stages, in order."""
    if cfg.graph_placement == "rowshard" and mesh is None:
        raise ValueError("graph_placement='rowshard' shards CSR rows over a "
                         "device mesh; pass --mesh N")
    device = mesh.device if mesh is not None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA device")
    writes = mesh is None or mesh.local_rank == 0   # once per host
    metrics.set("device", str(device))
    if cfg.support_mode == "walk_count" and cfg.mc_walks_per_end > 200:
        log.warning(
            "support_mode='walk_count' at %d walks/end: walk-count support is "
            "density-inflated (a chimeric junction gains count as fast as a "
            "real one) — use support_mode='read_diverse' at this density",
            cfg.mc_walks_per_end)
    if graph_artifact:
        with metrics.stage("load_sequences"):
            contigs = read_fasta(contigs_path, lazy=cfg.lazy_sequences)
            reads = read_fasta(reads_path, lazy=cfg.lazy_sequences)
        with metrics.stage("load_graph_artifact"):
            edges, graph = load_graph(graph_artifact, cfg)
        metrics.set("graph", graph.stats)
        if graph.split_read is not None:
            metrics.set("n_split_reads", int(graph.split_read.sum()))
    else:
        contigs, reads, paf = load_inputs(
            contigs_path, reads_path, paf_rc_path, paf_rr_path, metrics,
            lazy=cfg.lazy_sequences)
        edges, graph = build_graph(contigs, reads, paf, cfg, metrics, device=device)
        if save_graph_path and writes:
            with metrics.stage("save_graph_artifact"):
                save_graph(save_graph_path, edges, graph, cfg)

    resolved_placement = cfg.graph_placement
    if walks_artifact:
        # resume must equal the direct run: the rescue stage needs the placement
        # the direct run's walk stage would have resolved
        if mesh is not None:
            resolved_placement = _resolve_placement(
                cfg, graph, mesh, metrics).graph_placement
        with metrics.stage("load_walks_artifact"):
            plan, walks = load_walks(walks_artifact, cfg)
        metrics.set("n_walks", plan.n_active)
        with metrics.stage("consensus"):
            cons = _consensus(walks, plan, graph, cfg, device)
            bridges = compress(cons)
    else:
        with metrics.stage("plan_walks"):
            plan = plan_walks(graph, cfg, n_shards=mesh.size if mesh is not None else 1)
        metrics.set("n_walks", plan.n_active)
        walk_key = f"run_walks:W{_pow2_bucket(max(len(plan), 1))}:S{cfg.max_steps}"
        if mesh is not None:
            walk_cfg = _resolve_placement(cfg, graph, mesh, metrics)
            resolved_placement = walk_cfg.graph_placement
            with metrics.stage("run_walks"), \
                    _watch(metrics, f"{walk_key}:D{mesh.size}", device):
                # the records stay on their ranks; the gate and the stitcher
                # fetch the rows they read (fetch_walk_rows)
                walks, cons = run_walks_distributed(graph, plan, walk_cfg, mesh)
            with metrics.stage("consensus"):
                bridges = compress(cons)
        else:
            with metrics.stage("run_walks"), _watch(metrics, walk_key, device):
                walks_dev = run_walks_host(graph, plan, cfg, device)
            with metrics.stage("consensus"):
                cons = _consensus(walks_dev, plan, graph, cfg, device)
                bridges = compress(cons)
                walks = walks_dev.to_numpy()
            del walks_dev
        engine.count_steps_taken(walks)
        if save_walks_path:
            if mesh is not None and spans_hosts(mesh):
                log.warning("--save-walks skipped: records are sharded across "
                            "hosts; rerun on one host to save them")
            else:
                with metrics.stage("save_walks_artifact"):
                    # a collective on a mesh: every rank joins the fetch of all
                    # rows, rank 0 writes the one file
                    host = (fetch_walk_rows(walks, np.arange(len(plan)), mesh)
                            if isinstance(walks, ShardedWalks) else walks)
                    if mesh is None or mesh.rank == 0:
                        save_walks(save_walks_path, plan, host, cfg)

    if isinstance(walks, ShardedWalks):
        n_succ, n_trunc = count_walks(walks, cfg.max_steps, mesh)
    else:
        n_succ = int(walks.success.sum())
        # truncated = ran to the step bound without reaching an anchor
        n_trunc = int(((walks.steps >= cfg.max_steps) & ~walks.success).sum())
    metrics.set("n_walks_successful", n_succ)
    metrics.set("n_walks_truncated", n_trunc)
    log.info("walks: %d planned, %d successful, %d truncated at max_steps=%d",
             plan.n_active, n_succ, n_trunc, cfg.max_steps)
    if plan.n_active and n_trunc > 0.2 * plan.n_active:
        log.warning(
            "%.0f%% of walks truncated at max_steps=%d — real bridge paths may "
            "be longer; consider raising --max-steps",
            100 * n_trunc / plan.n_active, cfg.max_steps)
    metrics.set("n_bridges_candidate", len(bridges))

    # cut-read gate and copy-coherence demotion (host numpy; reference docs)
    blocked_rows: list = []
    if cfg.support_mode == "read_diverse":
        with metrics.stage("cut_read_gate"):
            bridges, blocked_rows = read_diversity_gate(
                bridges, cons, walks, graph.virtual_base, mesh=mesh,
                split_read=graph.split_read)
        metrics.set("n_bridges_cut_refused", len(blocked_rows))
        metrics.set("n_bridges_cut_clean",
                    sum(1 for r in bridges if "cut_reads" in r))
        if blocked_rows:
            log.info("cut-read gate: %d candidate bridge(s) refused on "
                     "single-point evidence (their winning ends stay blocked)",
                     len(blocked_rows))
        if cfg.copy_coherence_margin > 0:
            from telomeri_tpu_torch.consensus.coherence import annotate_pair_coherence

            with metrics.stage("coherence"):
                n_inc = annotate_pair_coherence(
                    bridges, cons, walks, edges, graph.virtual_base,
                    cfg.copy_coherence_margin, mesh=mesh)
            metrics.set("n_pairs_incoherent", n_inc)
            if n_inc:
                log.info("coherence: %d of %d candidate pair(s) have no "
                         "distinct path clear of cross-copy-signature edges; "
                         "demoted in conflict order", n_inc, len(bridges))

    with metrics.stage("resolve_conflicts"):
        accepted, blocked_ends = resolve_with_blockers(bridges, blocked_rows)
    metrics.set("n_bridges_accepted", len(accepted))
    metrics.set("n_ends_blocked", len(blocked_ends))
    log.info("bridges: %d candidates, %d accepted", len(bridges), len(accepted))

    # rescue rounds: dense MC re-walks of still-free walkable ends (also on a
    # --walks resume: resume must equal the direct run)
    rescue_paths: dict = {}
    if cfg.rescue_rounds > 0:
        rescue_gd = None   # replicated device tables, uploaded once
        for ri in range(cfg.rescue_rounds):
            if not free_walkable_ends(graph, accepted, blocked_ends):
                break
            if rescue_gd is None and resolved_placement != "rowshard":
                rescue_gd = walk_table.graph_to_device(graph, device)
            with metrics.stage(f"rescue_round_{ri}"), \
                    _watch(metrics, f"rescue_walks:R{ri}", device), span("rescue.round", index=ri):
                new, paths_ri, blocked_ends = run_rescue_round(
                    graph, cfg, accepted, ri, gd=rescue_gd,
                    blocked_ends=blocked_ends, device=device, mesh=mesh,
                    placement=resolved_placement)
            if not new:
                break
            accepted = accepted + new
            rescue_paths.update(paths_ri)
            log.info("rescue round %d: %d additional bridges accepted", ri, len(new))
        metrics.set("n_bridges_rescued", len(rescue_paths))
        metrics.set("n_bridges_accepted", len(accepted))   # incl. rescued

    with metrics.stage("stitch"):
        lut = plan.uid_to_row()
        rep_uids = [b.rep_uid for b in accepted if b.rep_uid not in rescue_paths]
        rows = np.array([lut[u] for u in rep_uids], np.int64)
        if isinstance(walks, ShardedWalks):   # only the representative rows
            rep = fetch_walk_rows(walks, rows, mesh)
            rows = np.arange(len(rep_uids))
        else:
            rep = walks
        paths = {
            u: extract_path(rep.nodes[i], rep.eids[i], int(rep.steps[i]),
                            virtual_base=graph.virtual_base)
            for u, i in zip(rep_uids, rows)
        }
        paths.update(rescue_paths)
        stitcher = Stitcher(contigs, reads, edges)
        scaffolds = emit_scaffolds(accepted, paths, stitcher)

    # junction polish: plurality re-call of fill bases over spanning reads
    if cfg.polish:
        from telomeri_tpu_torch.scaffold.polish import polish_scaffolds

        junction_reads = {tuple(r["pair"]): r["span_reads"]
                          for r in bridges if "span_reads" in r}
        for b in accepted:
            if tuple(b.pair) not in junction_reads:
                wp = paths.get(b.rep_uid)
                if wp is not None:
                    junction_reads[tuple(b.pair)] = sorted(
                        {n // 2 for n in wp.nodes[1:-1] if n // 2 >= len(contigs)})
        with metrics.stage("polish"):
            agg = polish_scaffolds(scaffolds, reads, junction_reads, len(contigs),
                                   flank=cfg.polish_flank, log=log)
        metrics.set("polish", agg)
    metrics.set("n_scaffolds", len(scaffolds))
    metrics.set("scaffold_lengths", [int(len(s.seq)) for s in scaffolds])
    from telomeri_tpu_torch.utils.stats import scaffold_vs_contig_stats

    metrics.set("assembly", scaffold_vs_contig_stats(
        [len(s.seq) for s in scaffolds], list(contigs.lengths)))

    if out_path and writes:
        with metrics.stage("write_fasta"):
            write_fasta(out_path, [s.name for s in scaffolds], [s.seq for s in scaffolds])
    if agp_path and writes:
        from telomeri_tpu_torch.scaffold.stitch import write_agp

        with metrics.stage("write_agp"):
            write_agp(agp_path, scaffolds, contigs, reads)

    return PipelineResult(
        scaffolds=scaffolds, graph=graph, edges=edges, plan=plan, walks=walks,
        bridges=bridges, accepted=accepted, metrics=metrics)

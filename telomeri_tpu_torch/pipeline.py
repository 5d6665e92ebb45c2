"""End-to-end scaffolding pipeline on one device: the port of telomeri_tpu/pipeline.py.

host ingest -> build_edges -> [device] optional rescoring -> tensorize ->
plan_walks -> [device] walks -> [device] consensus -> [host] cut-read gate and
coherence -> conflict resolution -> [device] one rescue round -> stitching ->
FASTA. The stages and their metrics are the reference's; the device work runs
in torch on `device` ("cuda" launches the hand-written kernels, "cpu" runs
their plain versions). Host stages receive host numpy arrays.

Not ported yet (ROADMAP.md, queue 1): a device mesh and the row-sharded graph
placement, graph and walks artifacts, and profiler traces; asking for any of
them raises NotImplementedError.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from telomeri_tpu.config import ScaffoldConfig  # re-exported: callers of the port take it from here
from telomeri_tpu.consensus.evidence import read_diversity_gate
from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.io.fasta import SequenceSet, read_fasta, write_fasta
from telomeri_tpu.io.geometry import EdgeSoA, split_evidence_mask, split_mapped
from telomeri_tpu.io.paf import PafRecords, parse_paf
from telomeri_tpu.scaffold.bridge import resolve_with_blockers
from telomeri_tpu.scaffold.stitch import Scaffold, Stitcher, emit_scaffolds, extract_path
from telomeri_tpu.utils.logging import Metrics, log
from telomeri_tpu.walk.plan import WalkPlan, plan_walks
from telomeri_tpu_torch.consensus.grouping import compress, group_and_select, summarize
from telomeri_tpu_torch.graph.tensorize import tensorize
from telomeri_tpu_torch.io.geometry import build_edges, rescore_edges_device
from telomeri_tpu_torch.walk.engine import WalkResult, graph_to_device, run_walks_host
from telomeri_tpu_torch.walk.rescue import free_walkable_ends, run_rescue_round

# "auto" device scoring engages at this many edges on a CUDA device. This is the
# reference's TPU cutover: build_edges scores every edge on the host anyway, so
# the rescore adds to a run at any size and the H100's measured crossover
# applies only once build_edges leaves scoring to the device (ROADMAP.md).
AUTO_SCORING_MIN_EDGES = 32_000_000


@dataclass
class PipelineResult:
    scaffolds: list[Scaffold]
    graph: GraphTensors
    edges: EdgeSoA
    plan: WalkPlan
    walks: WalkResult        # host numpy records
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
    from telomeri_tpu.native.paf_native import available as _native_ok

    backend = "native" if _native_ok() else "python"
    metrics.set("parser_backend", backend)
    if backend == "python":
        log.info("native parser library not built (python -m "
                 "telomeri_tpu.native.build); using the Python parsers")
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
            with metrics.stage("score_edges_device"):
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


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to telomeri_tpu_torch yet (ROADMAP.md, queue 1); "
        f"use telomeri_tpu for it")


def run_pipeline(
    contigs_path: str,
    reads_path: str,
    paf_rc_path: str | list[str] | None,
    paf_rr_path: str | list[str] | None,
    out_path: str | None,
    cfg: ScaffoldConfig = ScaffoldConfig(),
    metrics: Metrics | None = None,
    mesh=None,
    graph_artifact: str | None = None,
    save_graph_path: str | None = None,
    walks_artifact: str | None = None,
    save_walks_path: str | None = None,
    trace_dir: str | None = None,
    agp_path: str | None = None,
    *,
    device="cuda",
) -> PipelineResult:
    """Full single-device pipeline on `device` (the reference's arguments; the
    mesh, artifact and trace ones are not ported yet and raise)."""
    if mesh is not None or cfg.graph_placement == "rowshard":
        _not_ported("a device mesh / row-sharded graph placement")
    if graph_artifact or save_graph_path or walks_artifact or save_walks_path:
        _not_ported("graph and walks artifacts")
    if trace_dir or os.environ.get("TELOMERI_TRACE"):
        _not_ported("profiler tracing")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA device")
    metrics = metrics or Metrics()
    metrics.set("device", str(device))
    if cfg.support_mode == "walk_count" and cfg.mc_walks_per_end > 200:
        log.warning(
            "support_mode='walk_count' at %d walks/end: walk-count support is "
            "density-inflated (a chimeric junction gains count as fast as a "
            "real one) — use support_mode='read_diverse' at this density",
            cfg.mc_walks_per_end)
    contigs, reads, paf = load_inputs(
        contigs_path, reads_path, paf_rc_path, paf_rr_path, metrics,
        lazy=cfg.lazy_sequences)
    edges, graph = build_graph(contigs, reads, paf, cfg, metrics, device=device)

    with metrics.stage("plan_walks"):
        plan = plan_walks(graph, cfg)
    metrics.set("n_walks", plan.n_active)
    with metrics.stage("run_walks"):
        walks_dev = run_walks_host(graph, plan, cfg, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the stage time must see real work
    with metrics.stage("consensus"):
        summary = summarize(walks_dev, torch.from_numpy(plan.uid),
                            virtual_base=graph.virtual_base)
        cons = group_and_select(
            summary, n_anchors=graph.n_anchors, group_window=cfg.group_window,
            min_support=cfg.min_group_support, grouping=cfg.grouping,
            support=cfg.support_mode).to_numpy()
        bridges = compress(cons)
        walks = walks_dev.to_numpy()
    del walks_dev, summary

    n_succ = int(walks.success.sum())
    metrics.set("n_walks_successful", n_succ)
    # truncated = ran to the step bound without reaching an anchor
    n_trunc = int(((walks.steps >= cfg.max_steps) & ~walks.success).sum())
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
                bridges, cons, walks, graph.virtual_base, split_read=graph.split_read)
        metrics.set("n_bridges_cut_refused", len(blocked_rows))
        metrics.set("n_bridges_cut_clean",
                    sum(1 for r in bridges if "cut_reads" in r))
        if blocked_rows:
            log.info("cut-read gate: %d candidate bridge(s) refused on "
                     "single-point evidence (their winning ends stay blocked)",
                     len(blocked_rows))
        if cfg.copy_coherence_margin > 0:
            from telomeri_tpu.consensus.coherence import annotate_pair_coherence

            with metrics.stage("coherence"):
                n_inc = annotate_pair_coherence(
                    bridges, cons, walks, edges, graph.virtual_base,
                    cfg.copy_coherence_margin)
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

    # rescue rounds: dense MC re-walks of still-free walkable ends
    rescue_paths: dict = {}
    if cfg.rescue_rounds > 0:
        rescue_gd = None   # device tables, uploaded once
        for ri in range(cfg.rescue_rounds):
            if not free_walkable_ends(graph, accepted, blocked_ends):
                break
            if rescue_gd is None:
                rescue_gd = graph_to_device(graph, device)
            with metrics.stage(f"rescue_round_{ri}"):
                new, paths_ri, blocked_ends = run_rescue_round(
                    graph, cfg, accepted, ri, gd=rescue_gd,
                    blocked_ends=blocked_ends, device=device)
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
        paths = {
            u: extract_path(walks.nodes[lut[u]], walks.eids[lut[u]],
                            int(walks.steps[lut[u]]), virtual_base=graph.virtual_base)
            for u in rep_uids
        }
        paths.update(rescue_paths)
        stitcher = Stitcher(contigs, reads, edges)
        scaffolds = emit_scaffolds(accepted, paths, stitcher)

    # junction polish: plurality re-call of fill bases over spanning reads
    if cfg.polish:
        from telomeri_tpu.scaffold.polish import polish_scaffolds

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
    from telomeri_tpu.utils.stats import scaffold_vs_contig_stats

    metrics.set("assembly", scaffold_vs_contig_stats(
        [len(s.seq) for s in scaffolds], list(contigs.lengths)))

    if out_path:
        with metrics.stage("write_fasta"):
            write_fasta(out_path, [s.name for s in scaffolds], [s.seq for s in scaffolds])
    if agp_path:
        from telomeri_tpu.scaffold.stitch import write_agp

        with metrics.stage("write_agp"):
            write_agp(agp_path, scaffolds, contigs, reads)

    return PipelineResult(
        scaffolds=scaffolds, graph=graph, edges=edges, plan=plan, walks=walks,
        bridges=bridges, accepted=accepted, metrics=metrics)

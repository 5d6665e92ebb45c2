"""Per-gap bridge diagnosis on simulated datasets: the port of tools/gap_report.py.

For a run whose contigs are in genome order (the simulator writes ctg000,
ctg001, ... left to right), every adjacent pair (c, c+1) is a ground-truth gap
the scaffolder should bridge. This replays consensus, the cut-read gate,
copy coherence and conflict resolution from the saved artifacts and reports,
for every UNBRIDGED gap, where the bridge was lost:

  no-walks        no plan rows leave either flanking end
  no-connection   walks ran but none connected the two flanking ends (with
                  how many truncated at max_steps, died mid-graph, or landed
                  on other anchors)
  gate-refused    the pair won its consensus but the cut-read gate refused it
  lost-conflict   the pair's bridge was valid but conflict resolution rejected it
  low-support     a connecting group formed but count < min_group_support
  lost-consensus  connecting walks exist but another group won the pair

The consensus, gate and coherence are this package's; the consensus runs on
the card unless the CPU is asked for (it is bit-equal on both), the gate and
coherence on host numpy records. The report is the reference tool's, key for
key, so both print the same JSON on the same run directory. No jax is imported.

    python -m telomeri_tpu_torch.gap_report RUNDIR [--device {cuda,cpu}]
        # RUNDIR holds graph.npz, walks.npz and <out>.config.json from
        # `scaffold --save-graph RUNDIR/graph.npz --save-walks RUNDIR/walks.npz`
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import numpy as np
import torch

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.scaffold.bridge import End, resolve_with_blockers, terminal_end
from telomeri_tpu_torch.consensus.coherence import annotate_pair_coherence
from telomeri_tpu_torch.consensus.evidence import read_diversity_gate
from telomeri_tpu_torch.consensus.grouping import compress
from telomeri_tpu_torch.io.artifacts import load_graph, load_walks
from telomeri_tpu_torch.pipeline import _consensus


def canonical_pair(a: int, b: int) -> tuple[int, int]:
    """Consensus rule 2's canonical undirected pair."""
    ra, rb = b ^ 1, a ^ 1
    return (ra, rb) if (ra, rb) < (a, b) else (a, b)


def _load(rundir: str):
    cfgp = sorted(f for f in os.listdir(rundir) if f.endswith(".config.json"))
    cfg = ScaffoldConfig()
    if cfgp:   # machine-written: a field this version lacks must not block diagnosis
        with open(os.path.join(rundir, cfgp[0])) as f:
            cfg = ScaffoldConfig.from_json(f.read(), strict=False)
    edges, graph = load_graph(os.path.join(rundir, "graph.npz"), cfg)
    plan, walks = load_walks(os.path.join(rundir, "walks.npz"), cfg)
    return cfg, edges, graph, plan, walks


def _no_connection(rows: np.ndarray, succ, steps, term, max_steps: int) -> dict:
    other = Counter()
    for i in rows:
        if succ[i]:
            e = terminal_end(int(term[i]))
            other[f"{e.contig}{'R' if e.right else 'L'}"] += 1
    return dict(verdict="no-connection",
                truncated_at_max_steps=int(((steps[rows] >= max_steps) & ~succ[rows]).sum()),
                died_mid_graph=int((~succ[rows] & (steps[rows] < max_steps)).sum()),
                reached_other_anchors=dict(other.most_common(5)))


def diagnose(rundir: str, out=sys.stdout, device="cuda") -> dict:
    """Print (and return) the report of the run directory's unbridged gaps; the
    consensus is replayed on `device` (no step down to the CPU without a card)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA device")
    cfg, edges, graph, plan, walks = _load(rundir)
    n_c = graph.n_anchors
    cons = _consensus(walks, plan, graph, cfg, device)
    rows = compress(cons)
    blocked_rows = []
    if cfg.support_mode == "read_diverse":
        rows, blocked_rows = read_diversity_gate(rows, cons, walks, graph.virtual_base,
                                                 split_read=graph.split_read)
        if cfg.copy_coherence_margin > 0:
            annotate_pair_coherence(rows, cons, walks, edges, graph.virtual_base,
                                    cfg.copy_coherence_margin)
    accepted, _ = resolve_with_blockers(rows, blocked_rows)
    acc_pairs = {b.pair for b in accepted}
    blocked_pair = {tuple(r["pair"]): r for r in blocked_rows}
    split_flags = np.asarray(graph.split_read) if graph.split_read is not None else None
    end_owner: dict[End, tuple[int, int]] = {}
    for b in accepted:
        end_owner[b.end_a] = end_owner[b.end_b] = b.pair

    # every segment of a pair (count, bucket, valid), and the winners' buckets
    seg_by_pair: dict[tuple[int, int], list] = {}
    win_bucket = {}
    for i in np.flatnonzero(cons.count > 0):
        p = (int(cons.pair_a[i]), int(cons.pair_b[i]))
        seg_by_pair.setdefault(p, []).append(
            (int(cons.count[i]), int(cons.bucket[i]), bool(cons.valid[i])))
        if cons.valid[i]:
            win_bucket[p] = int(cons.bucket[i])

    start = np.asarray(walks.nodes[:, 0])
    term = np.asarray(walks.terminal)
    succ = np.asarray(walks.success)
    steps = np.asarray(walks.steps)
    active = np.asarray(plan.active)

    def walks_leaving(end: End) -> np.ndarray:
        return np.flatnonzero(active & (start == 2 * end.contig + (0 if end.right else 1)))

    report = dict(n_contigs=n_c, n_gaps=n_c - 1, bridged=0, missed=[])
    for c in range(n_c - 1):
        pair = canonical_pair(2 * c, 2 * c + 2)   # gap c: (c)R -- (c+1)L
        if pair in acc_pairs:
            report["bridged"] += 1
            continue
        e_r, e_l = End(c, True), End(c + 1, False)
        both = np.concatenate([walks_leaving(e_r), walks_leaving(e_l)])
        conn = [i for i in both
                if succ[i] and canonical_pair(int(start[i]), int(term[i])) == pair]
        diag = dict(gap=c, pair=pair, n_walks=int(len(both)), n_connecting=len(conn))
        if not len(both):
            deg = np.asarray(graph.deg)   # 0 / 0 is a coverage hole, else a planner fault
            diag.update(verdict="no-walks", flank_out_degrees={
                str(e_r): int(deg[2 * c]), str(e_l): int(deg[2 * (c + 1) + 1])})
        elif not conn:
            diag.update(_no_connection(both, succ, steps, term, cfg.max_steps))
        elif pair in blocked_pair:
            r = blocked_pair[pair]
            cut = r.get("cut_reads", [])
            diag.update(verdict="gate-refused", cut_reads=cut)
            if split_flags is not None:
                diag["cut_reads_split_mapped"] = [bool(split_flags[x]) for x in cut]
            diag["distinct_paths"] = int(r.get("distinct", r["count"]))
            diag["note"] = ("single-point evidence: all cut reads "
                            "split-mapped/unknown; ends blocked by design")
        elif pair in win_bucket:
            diag["verdict"] = "lost-conflict"
            owners = {str(e): end_owner.get(e) for e in (e_r, e_l) if e in end_owner}
            diag["ends_claimed_by"] = {k: list(v) for k, v in owners.items()
                                       if v is not None}
            if not owners:
                diag["note"] = ("pair valid in consensus but rejected by "
                                "cycle rule (union-find)")
        else:
            segs = seg_by_pair.get(pair, [])
            best = max((s[0] for s in segs), default=0)
            if best and best < cfg.min_group_support:
                diag.update(verdict="low-support", best_group_count=best,
                            min_group_support=cfg.min_group_support)
            else:
                diag.update(verdict="lost-consensus", segments=segs[:8])
        report["missed"].append(diag)

    json.dump(report, out, indent=1)
    out.write("\n")
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m telomeri_tpu_torch.gap_report",
                                 description="Per-gap bridge diagnosis of a saved run.")
    ap.add_argument("rundir", metavar="RUNDIR",
                    help="holds graph.npz, walks.npz and <out>.config.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the consensus is replayed (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: torch sees no CUDA device (use --device cpu)", file=sys.stderr)
        return 1
    diagnose(args.rundir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

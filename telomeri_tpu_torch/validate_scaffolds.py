"""Resumable per-scaffold validation: the port of tools/validate_scaffolds.py.

Genome-scale validation of a multi-Gb assembly in one process is fragile: the
per-scaffold serial phase runs tens of minutes to hours, and a kill loses all
progress (there is no resume inside the process). This tool runs
utils.validate.validate_assembly ONE SCAFFOLD PER CHILD PROCESS:

  * progress is durable — each scaffold's placement lands in
    SCAFFOLDS.validate_parts/<name>.json the moment it finishes, and a rerun
    skips finished scaffolds;
  * memory is returned to the OS between scaffolds (the child exits), and
    MALLOC_MMAP_THRESHOLD_/TRIM are pinned so glibc reuses heap pages
    instead of mmap-churning fresh ones;
  * the reference index loads from the resumable mmap cache per child
    (utils.validate._cached_index).

Usage:
  python -m telomeri_tpu_torch.validate_scaffolds --scaffolds out.fa --genome g.fa \
      [--agp out.agp] [--sample 16] [--stride 64] [--jobs 2] [--out report.json]

The merged report matches validate_assembly's schema. A child is this module
again with --one NAME --part FILE; it imports this package's io.fasta and
utils.validate (utils/launch.py hands the package's location on).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from telomeri_tpu_torch.io.fasta import SequenceSet, read_fasta
from telomeri_tpu_torch.utils.launch import child_env
from telomeri_tpu_torch.utils.validate import read_agp_junctions, validate_assembly

CHILD_ENV = {
    # medium numpy temporaries come from the heap, not fresh mmaps: the
    # per-anchor-gap alloc/free pattern otherwise charges/unmaps GBs of
    # pages per second (kernel memcg churn)
    "MALLOC_MMAP_THRESHOLD_": str(1 << 30),
    "MALLOC_TRIM_THRESHOLD_": str(1 << 30),
}


def validate_one(args, name: str, part: str) -> None:
    """The child's work: validate scaffold `name` alone and write its report
    to `part` atomically."""
    scafs = read_fasta(args.scaffolds, lazy="auto")
    i = scafs.names.index(name)
    one = SequenceSet([scafs.names[i]], [np.asarray(scafs.seqs[i])])
    junc = read_agp_junctions(args.agp) if args.agp else None
    rep = validate_assembly(one, read_fasta(args.genome, lazy="auto"),
                            k=args.seed_kmer, stride=args.stride,
                            junctions=junc, sample=args.sample,
                            n_jobs=args.jobs,
                            index_cache_dir=os.path.dirname(os.path.abspath(args.genome)))
    with open(part + ".tmp", "w") as f:
        json.dump(rep, f)
    os.replace(part + ".tmp", part)


def run_child(args, name: str, part: str) -> int:
    cmd = [sys.executable, "-m", "telomeri_tpu_torch.validate_scaffolds",
           "--scaffolds", args.scaffolds, "--genome", args.genome,
           "--seed-kmer", str(args.seed_kmer), "--stride", str(args.stride),
           "--sample", str(args.sample), "--jobs", str(args.jobs),
           "--one", name, "--part", part]
    if args.agp:
        cmd += ["--agp", args.agp]
    return subprocess.run(cmd, env=child_env(**CHILD_ENV)).returncode


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m telomeri_tpu_torch.validate_scaffolds")
    ap.add_argument("--scaffolds", required=True)
    ap.add_argument("--genome", required=True)
    ap.add_argument("--agp", default=None)
    ap.add_argument("--seed-kmer", type=int, default=24)
    ap.add_argument("--stride", type=int, default=64)
    ap.add_argument("--sample", type=int, default=16)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", metavar="NAME", help=argparse.SUPPRESS)   # child mode
    ap.add_argument("--part", metavar="FILE", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one is not None:
        if not a.part:
            ap.error("--one needs --part")
        validate_one(a, a.one, a.part)
        return 0

    scafs = read_fasta(a.scaffolds, lazy="auto")
    # keyed by the scaffolds FILE so two assemblies in one directory (e.g.
    # polished vs unpolished) never share or steal each other's parts
    parts_dir = os.path.abspath(a.scaffolds) + ".validate_parts"
    os.makedirs(parts_dir, exist_ok=True)
    # big scaffolds first: the expensive work starts immediately and the
    # cheap tail survives even a near-deadline kill
    order = sorted(range(len(scafs.names)), key=lambda i: -int(scafs.lengths[i]))
    reports = []
    for i in order:
        name = scafs.names[i]
        part = os.path.join(parts_dir, f"{name}.json")
        if os.path.exists(part):
            print(f"[validate_scaffolds] {name}: already done, skipping", file=sys.stderr)
        else:
            t0 = time.time()
            rc = run_child(a, name, part)
            print(f"[validate_scaffolds] {name} ({int(scafs.lengths[i])} bp): rc={rc} "
                  f"in {time.time()-t0:.0f}s", file=sys.stderr, flush=True)
            if rc != 0:
                continue
        with open(part) as f:
            reports.append(json.load(f))

    # merge into the validate_assembly schema
    placements = [p for r in reports for p in r["placements"]]
    total = int(sum(scafs.lengths))
    placed_span = sum(p["span"] for p in placements)
    wsum = sum(p["identity"] * p["span"] for p in placements)
    placed = [p for p in placements if p["genome"] is not None]
    worst_j = [r["worst_junction_identity"] for r in reports
               if "worst_junction_identity" in r]
    merged = {
        "n_scaffolds": len(scafs.names),
        "n_validated": len(placements),
        "n_placed": len(placed),
        "total_bases": total,
        "placed_bases": int(placed_span),
        "placed_fraction": round(placed_span / total, 6) if total else 0.0,
        "mean_identity": round(wsum / placed_span, 6) if placed_span else 0.0,
        "worst_identity": round(min((p["identity"] for p in placed),
                                    default=0.0), 6),
        "placements": placements,
    }
    if any(r.get("sampled") for r in reports):
        merged["sampled"] = True
        merged["max_identity_stderr"] = round(
            max(r.get("max_identity_stderr", 0.0) for r in reports), 6)
    if worst_j:
        merged["worst_junction_identity"] = round(min(worst_j), 6)
    out = a.out or (a.scaffolds + ".validate.json")
    with open(out, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
    print(json.dumps({k: v for k, v in merged.items() if k != "placements"},
                     indent=1, sort_keys=True))
    return 0 if len(placements) == len(scafs.names) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry point of the port: `telomeri-tpu-torch`.

  telomeri-tpu-torch scaffold --contigs c.fa --reads r.fa --paf-read-contig rc.paf \
      --paf-read-read rr.paf --out scaffolds.fa [--device cuda|cpu] [--config cfg.json] \
      [--graph G | --save-graph G] [--walks W | --save-walks W] [--trace DIR] \
      [ScaffoldConfig flags]
  telomeri-tpu-torch scaffold --mesh N ...     (starts its N ranks itself)
  torchrun --nproc-per-node N -m telomeri_tpu_torch.cli.main scaffold --mesh N ...
  telomeri-tpu-torch simulate --out DIR [--preset P] [SimConfig flags]
  telomeri-tpu-torch validate --scaffolds S.fa --genome G.fa [--agp FILE] ...
  telomeri-tpu-torch stats FASTX...

`scaffold` takes the reference CLI's flags (every ScaffoldConfig field is one)
plus --device: "cuda" (the default) runs the device stages and the
hand-written kernels on the GPU and fails when there is none; "cpu" runs their
plain torch versions. --mesh N shards the walks over N devices, one process
each (NCCL for cuda, gloo for cpu): under torchrun with N processes it joins
that world; without a launcher the command starts the N ranks itself, by
running its own command line again under `python -m torch.distributed.run
--standalone --nproc-per-node N`, and returns their exit code. --mesh 1 runs as
one plain process. As in the reference, the resolved
config and the stage metrics are written next to the FASTA (<out>.config.json,
<out>.metrics.json), once per host. simulate, validate and stats are host-only
and take the reference CLI's arguments; they import neither torch nor the
device modules.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.utils.launch import check_devices_or_launch
from telomeri_tpu_torch.utils.logging import Metrics, log, setup_logging


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _parse_int_tuple(s: str) -> tuple:
    """Comma-separated ints -> tuple (e.g. --inverted-copies 1,3); '' -> ()."""
    return tuple(int(x) for x in s.split(",") if x.strip() != "")


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(ScaffoldConfig):
        flag = "--" + f.name.replace("_", "-")
        # argparse's type=bool would parse "--flag False" as True (any nonempty
        # string is truthy); map bool fields through an explicit parser.
        ty = type(f.default)
        if ty is bool:
            ty = _parse_bool
        p.add_argument(flag, type=ty, default=None,
                       help=f"override config field {f.name} (default {f.default})")


def _config_from_args(args) -> ScaffoldConfig:
    base = {}
    if getattr(args, "config", None):
        with open(args.config) as f:
            base = dataclasses.asdict(ScaffoldConfig.from_json(f.read()))
    for f in dataclasses.fields(ScaffoldConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            base[f.name] = v
    return ScaffoldConfig(**base)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="telomeri-tpu-torch",
        description="repeat-resolving scaffolder, PyTorch / CUDA port")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--version", action="version", version="telomeri-tpu-torch 0.1.0")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("scaffold", help="bridge contigs across repeats using long reads")
    s.add_argument("--contigs", required=True, help="draft contigs FASTA")
    s.add_argument("--reads", required=True, help="long reads FASTA/FASTQ")
    s.add_argument("--paf-read-contig", nargs="+",
                   help="minimap2 PAF: reads vs contigs, one or more files "
                        "(omit when resuming --graph)")
    s.add_argument("--paf-read-read", nargs="+",
                   help="minimap2 PAF: reads vs reads, one or more files "
                        "(omit when resuming --graph)")
    s.add_argument("--out", required=True, help="output scaffolds FASTA")
    s.add_argument("--config", help="ScaffoldConfig JSON (flags override it)")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device stages run (default cuda)")
    s.add_argument("--graph", help="resume: load tensorized graph artifact (.npz)")
    s.add_argument("--save-graph", help="save tensorized graph artifact (.npz)")
    s.add_argument("--walks", help="resume: load walk-table artifact (.npz)")
    s.add_argument("--save-walks", help="save walk-table artifact (.npz)")
    s.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard walks over N devices, one process each, started "
                        "here unless a launcher (torchrun) already did "
                        "(0 = single device)")
    s.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler trace of the walk stage to DIR")
    s.add_argument("--agp", metavar="FILE",
                   help="also write scaffold composition as AGP v2.1")
    _add_config_flags(s)

    t = sub.add_parser("stats", help="print assembly stats (N50 etc.) for FASTA/FASTQ files")
    t.add_argument("fastx", nargs="+", help="FASTA/FASTQ files (.gz ok)")

    v = sub.add_parser(
        "validate",
        help="align scaffolds to a known reference genome and report identity "
             "(indel-tolerant: k-mer anchor chains + banded edit distance)")
    v.add_argument("--scaffolds", required=True, help="scaffolds FASTA")
    v.add_argument("--genome", required=True, help="reference genome FASTA")
    v.add_argument("--seed-kmer", type=int, default=24,
                   help="anchor k-mer length (<= 31)")
    v.add_argument("--stride", type=int, default=32,
                   help="scaffold anchor sampling stride (bp)")
    v.add_argument("--agp", metavar="FILE",
                   help="AGP from the scaffold run: also report identity in a "
                        "window around every stitch junction")
    v.add_argument("--junction-window", type=int, default=2000,
                   help="half-window around each junction (bp)")
    v.add_argument("--sample", type=int, default=1,
                   help="align every Nth segment, estimate the rest with error "
                        "bars (junction windows + misjoin detection stay exact)")
    v.add_argument("--jobs", type=int, default=0,
                   help="worker processes for segment alignment "
                        "(0 = all CPU cores; results identical at any count)")
    v.add_argument("--index-cache", metavar="DIR", default="auto",
                   help="persist the reference k-mer index (minutes to build "
                        "at genome scale, loads memory-mapped in seconds): "
                        "'auto' = next to the genome file, 'off' = disable, "
                        "or an explicit directory")

    g = sub.add_parser("simulate", help="generate a synthetic test dataset")
    g.add_argument("--out", required=True, help="output directory")
    from telomeri_tpu_torch.sim import PRESETS, SimConfig
    g.add_argument("--preset", choices=sorted(PRESETS),
                   help="evaluation-config preset (flags override its fields)")
    for f in dataclasses.fields(SimConfig):
        ty = type(f.default)
        if ty is bool:
            ty = _parse_bool
        elif ty is tuple:   # e.g. --inverted-copies 1,3 / --dropout-starts 40000
            ty = _parse_int_tuple
        g.add_argument("--" + f.name.replace("_", "-"), type=ty,
                       default=None, help=f"default {f.default}")
    return ap


def _host_command(args) -> int:
    """stats / validate / simulate: the reference CLI's host-only subcommands."""
    import json

    if args.cmd == "stats":
        from telomeri_tpu_torch.io.fasta import read_fasta
        from telomeri_tpu_torch.utils.stats import assembly_stats

        # lazy="auto": stats only needs lengths, which the mmap index provides
        # without materializing whole-genome sequence bytes
        out = {p: assembly_stats(read_fasta(p, lazy="auto").lengths) for p in args.fastx}
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0

    if args.cmd == "validate":
        from telomeri_tpu_torch.io.fasta import read_fasta
        from telomeri_tpu_torch.utils.validate import read_agp_junctions, validate_assembly

        cache_dir = (None if args.index_cache == "off"
                     else os.path.dirname(os.path.abspath(args.genome))
                     if args.index_cache == "auto" else args.index_cache)
        report = validate_assembly(
            read_fasta(args.scaffolds, lazy="auto"),
            read_fasta(args.genome, lazy="auto"),
            k=args.seed_kmer, stride=args.stride,
            junctions=read_agp_junctions(args.agp) if args.agp else None,
            junction_window=args.junction_window,
            sample=args.sample, n_jobs=args.jobs or (os.cpu_count() or 1),
            index_cache_dir=cache_dir)
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0

    from telomeri_tpu_torch.sim import PRESETS, SimConfig, simulate, write_dataset

    base = PRESETS[args.preset] if args.preset else SimConfig()
    fields = {
        f.name: getattr(args, f.name) if getattr(args, f.name) is not None
        else getattr(base, f.name)
        for f in dataclasses.fields(SimConfig)
    }
    data = simulate(SimConfig(**fields))
    write_dataset(data, args.out)
    log.info("wrote dataset to %s (%d contigs, %d reads, %d+%d paf rows)",
             args.out, len(data.contigs), len(data.reads),
             len(data.paf_read_contig), len(data.paf_read_read))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    if args.cmd != "scaffold":
        return _host_command(args)
    if not args.graph and not (args.paf_read_contig and args.paf_read_read):
        parser.error("--paf-read-contig and --paf-read-read are required unless "
                     "resuming from --graph")

    rc = check_devices_or_launch(parser, args.device, args.mesh, "telomeri_tpu_torch.cli.main",
                                 sys.argv[1:] if argv is None else argv)
    if rc is not None:
        return rc

    from telomeri_tpu_torch.dist.mesh import (
        init_distributed,
        make_walk_mesh,
        shutdown_distributed,
    )
    from telomeri_tpu_torch.pipeline import run_pipeline

    cfg = _config_from_args(args)
    metrics = Metrics()
    mesh = None
    if args.mesh:
        init_distributed(args.device)
        try:
            mesh = make_walk_mesh(args.mesh, args.device)
        except ValueError as e:
            shutdown_distributed()
            parser.error(str(e))
    try:
        res = run_pipeline(args.contigs, args.reads, args.paf_read_contig,
                           args.paf_read_read, args.out, cfg, metrics, mesh=mesh,
                           graph_artifact=args.graph, save_graph_path=args.save_graph,
                           walks_artifact=args.walks, save_walks_path=args.save_walks,
                           trace_dir=args.trace, agp_path=args.agp, device=args.device)
    finally:
        if mesh is not None:
            shutdown_distributed()
    if mesh is None or mesh.local_rank == 0:
        with open(args.out + ".config.json", "w") as f:
            f.write(cfg.to_json())
        metrics.dump(args.out + ".metrics.json")
        log.info("wrote %d scaffolds to %s", len(res.scaffolds), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

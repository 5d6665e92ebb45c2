"""Command-line entry point of the port: `telomeri-tpu-torch`.

  telomeri-tpu-torch scaffold --contigs c.fa --reads r.fa --paf-read-contig rc.paf \
      --paf-read-read rr.paf --out scaffolds.fa [--device cuda|cpu] [--config cfg.json] \
      [--graph G | --save-graph G] [--walks W | --save-walks W] [--trace DIR] \
      [ScaffoldConfig flags]
  torchrun --nproc-per-node N -m telomeri_tpu_torch.cli.main scaffold --mesh N ...
  telomeri-tpu-torch simulate|validate|stats ...     (host-only, as telomeri-tpu)

`scaffold` takes the reference CLI's flags (every ScaffoldConfig field is one)
plus --device: "cuda" (the default) runs the device stages and the
hand-written kernels on the GPU and fails when there is none; "cpu" runs their
plain torch versions. --mesh N shards the walks over N devices, one process
each, so it runs under torchrun with N processes (NCCL for cuda, gloo for cpu);
--mesh 1 also runs as one plain process. As in the reference, the resolved
config and the stage metrics are written next to the FASTA (<out>.config.json,
<out>.metrics.json), once per host. The host-only subcommands are the
reference's own, which never import jax.

The flags and their parsing come from two private helpers of the reference CLI,
`telomeri_tpu.cli.main._add_config_flags` and `_config_from_args`: a change to
either there changes this CLI too (test_cli_scaffold_cpu_reproduces_golden in
tests/test_torch_pipeline.py is the check that notices).
"""

from __future__ import annotations

import argparse
import sys

from telomeri_tpu.cli import main as reference_cli
from telomeri_tpu.utils.logging import Metrics, log, setup_logging


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
                   help="shard walks over N devices, one torchrun process each "
                        "(0 = single device)")
    s.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler trace of the walk stage to DIR")
    s.add_argument("--agp", metavar="FILE",
                   help="also write scaffold composition as AGP v2.1")
    reference_cli._add_config_flags(s)

    for name, text in (("stats", "print assembly stats (N50 etc.)"),
                       ("validate", "align scaffolds to a reference genome"),
                       ("simulate", "generate a synthetic test dataset")):
        # arguments are the reference CLI's; they pass through unparsed
        sub.add_parser(name, help=f"{text} (as telomeri-tpu {name})", add_help=False)
    return ap


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if args.cmd != "scaffold":
        return reference_cli.main((["-v"] if args.verbose else []) + [args.cmd, *rest])
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    setup_logging(args.verbose)
    if not args.graph and not (args.paf_read_contig and args.paf_read_read):
        parser.error("--paf-read-contig and --paf-read-read are required unless "
                     "resuming from --graph")

    import torch

    from telomeri_tpu_torch.dist.mesh import (
        init_distributed,
        make_walk_mesh,
        shutdown_distributed,
    )
    from telomeri_tpu_torch.pipeline import run_pipeline

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: torch sees no CUDA device (use --device cpu)")
    cfg = reference_cli._config_from_args(args)
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

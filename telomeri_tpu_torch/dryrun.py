"""Multi-device dry run of the port: the counterpart of the reference's
__graft_entry__.py dryrun_multichip(n).

    python -m telomeri_tpu_torch.dryrun [--mesh N] [--device {cuda,cpu}]

One step of the FULL device pipeline on a tiny simulated problem, over a world
of N processes (one per device; NCCL for cuda, gloo for cpu; without a
launcher `--mesh N` starts its N ranks itself, as the CLI does):

  1. every edge is re-scored on the device (kernels/scoring.py, 2 outputs), and
     the packed walk table's cum and ES blocks are rebuilt on the device from
     those scores (kernels/walk_table.py mc_weights_torch); the rebuilt table
     must equal the one the host packed, bit for bit;
  2. the walks run sharded over the world on the rebuilt table;
  3. the per-walk summaries are gathered and the consensus
     (support="read_diverse") runs on every rank;
  4. walks and consensus must equal a one-device run of the same plan, field
     by field, on the replicated mesh and on the row-sharded placement, and the
     generic mixed-mode engine must give the sectioned engine's records;
  5. run_pipeline (junction polish on) must write the same FASTA on one device,
     on the replicated mesh and row-sharded.

Any difference raises. Rank 0 prints the per-shard active / successful table
(a skewed table means the plan's sharding, not the interconnect, limits
scaling) and one JSON line; the exit code is not 0 if any rank failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

from telomeri_tpu_torch.utils.launch import check_devices_or_launch

INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")


def _tiny_problem(n_shards: int, dataset_dir: str, device, mc_walks: int = 16,
                  max_steps: int = 24):
    """Simulate a small dataset into dataset_dir and build graph + plan (host
    side). max_steps=24: at 12 about a quarter of the tiny problem's walks hit
    the step bound and the pipeline's truncation warning fires for a sizing
    artifact."""
    from telomeri_tpu_torch.config import ScaffoldConfig
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs
    from telomeri_tpu_torch.sim import SimConfig, simulate, write_dataset
    from telomeri_tpu_torch.walk.plan import plan_walks

    cfg = ScaffoldConfig(mc_walks_per_end=mc_walks, max_steps=max_steps)
    sim = simulate(SimConfig(
        genome_len=16000, repeat_len=1000, n_repeat_copies=2,
        read_len_mean=900, read_len_sd=120, coverage=10.0,
        error_rate=0.02, seed=0))
    write_dataset(sim, dataset_dir)
    contigs, reads, paf = load_inputs(*[os.path.join(dataset_dir, f) for f in INPUTS])
    edges, graph = build_graph(contigs, reads, paf, cfg, device=device)
    plan = plan_walks(graph, cfg, n_shards=n_shards)
    return cfg, edges, graph, plan


def rebuild_walk_table(gd, edges, device):
    """The packed walk table with its cum and ES blocks recomputed on `device`
    from a fresh device scoring of every edge.

    Slots that are real edges (eid >= 0) take ES2 of their edge and the weight
    kernels/walk_table.py mc_weights_torch gives it. Slots that are not (pads,
    eid -1; hierarchy hops, eid -2) keep their ORIGINAL weight from the packed
    cum block: pads difference to 0, so the cumsum carries the row total into
    them as pack_wide does, and hop subtree weights are computed on the host
    and cannot be re-derived here."""
    from telomeri_tpu_torch.kernels.scoring import score_overlaps
    from telomeri_tpu_torch.kernels.walk_table import GraphDev, blocks, mc_weights_torch

    geom = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in edges.geom_args()]
    _, es_edges = score_overlaps(*geom, outputs=2)
    row = blocks(gd.wide)
    eid_ok = row.eid >= 0
    zero = torch.zeros((), dtype=torch.float32, device=gd.wide.device)
    if es_edges.numel():
        es_tab = torch.where(eid_ok, es_edges[row.eid.clamp_min(0).long()], zero)
    else:
        es_tab = torch.zeros(row.eid.shape, dtype=torch.float32, device=gd.wide.device)
    w_orig = torch.diff(row.cum, dim=1, prepend=torch.zeros_like(row.cum[:, :1]))
    w = torch.where(eid_ok, mc_weights_torch(es_tab), w_orig)
    cumw = torch.cumsum(w, dim=1, dtype=torch.int32)
    return GraphDev(wide=torch.cat(row._replace(
        cum=cumw, es_bits=es_tab.contiguous().view(torch.int32)), dim=1).contiguous())


def _fields_equal(ref, got, what: str) -> None:
    """Every field of two records / consensus results equal (float32 fields by
    their bits); raises AssertionError naming the field."""
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f)
        if a is None or b is None:   # optional fields (e.g. win_distinct)
            if not (a is None and b is None):
                raise AssertionError(f"{what}: optional field {f!r} present on one side only")
            continue
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if a.dtype == np.float32 and b.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError(f"{what}: field {f!r} diverged from the 1-device reference")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run as this process's rank of a world of n_devices (joined
    from the launcher's environment, or a world of 1 in this process). Returns
    the summary that rank 0 prints."""
    from telomeri_tpu_torch.consensus.grouping import walk_consensus
    from telomeri_tpu_torch.dist.mesh import (
        fetch_walk_rows,
        gathered_consensus,
        init_distributed,
        make_walk_mesh,
        run_walk_shards,
        shutdown_distributed,
    )
    from telomeri_tpu_torch.dist.rowshard import run_walks_rowsharded
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts
    from telomeri_tpu_torch.pipeline import run_pipeline
    from telomeri_tpu_torch.kernels.walk_table import graph_to_device
    from telomeri_tpu_torch.walk.engine import plan_to_device, run_walks, run_walks_sectioned

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA device")
    reset_launch_counts()
    init_distributed(device)
    try:
        mesh = make_walk_mesh(n_devices, device)
        dev = mesh.device
        with tempfile.TemporaryDirectory() as d:   # each rank simulates its own copy
            cfg, edges, graph, plan = _tiny_problem(n_devices, d, dev)
            seed, kw = cfg.mc_seed, dict(n_anchors=graph.n_anchors, max_steps=cfg.max_steps)
            all_rows = np.arange(len(plan))

            # stage 1: device rescoring -> the walk table's cum and ES blocks
            gd_host = graph_to_device(graph, dev)
            gd = rebuild_walk_table(gd_host, edges, dev)
            if not torch.equal(gd.wide, gd_host.wide):
                bad = (gd.wide != gd_host.wide).any(dim=0).nonzero()[:, 0] // gd.h
                raise AssertionError("the walk table rebuilt from device scores differs from "
                                     f"the host's in column blocks {sorted(set(bad.tolist()))}")
            # stages 2 + 3: sharded walks on the rebuilt table, gathered consensus
            walks = run_walk_shards(gd, plan, seed, mesh=mesh, **kw)
            cons = gathered_consensus(walks, plan, mesh, cfg, virtual_base=graph.virtual_base,
                                      support="read_diverse")
            # stage 4: parity with one device, field by field
            res_1 = run_walks_sectioned(gd_host, plan, seed, **kw)
            what = f"{n_devices}-device"
            _fields_equal(res_1, fetch_walk_rows(walks, all_rows, mesh),
                          f"{what} replicated walks")
            cons_1 = walk_consensus(res_1, torch.from_numpy(plan.uid), cfg,
                                    virtual_base=graph.virtual_base, support="read_diverse")
            _fields_equal(cons_1, cons, f"{what} consensus")
            _fields_equal(res_1, run_walks(gd, plan_to_device(plan, dev), seed, **kw),
                          "mixed-mode walks")
            res_rs = run_walks_rowsharded(graph, plan, seed, max_steps=cfg.max_steps, mesh=mesh)
            _fields_equal(res_1, fetch_walk_rows(res_rs, all_rows, mesh), "row-sharded walks")
            n_succ = int(res_1.success.sum())
            n_bridge = int(cons.valid.sum())
            if n_succ <= 0:
                raise AssertionError("dry run produced no successful walks")

            # stage 5: the pipeline's FASTA on one device, on the mesh, row-sharded
            # (polish on: its spanning-read sets ride the gates' collective row fetch)
            args = [os.path.join(d, f) for f in INPUTS]
            pcfg = dataclasses.replace(cfg, polish=True, device_scoring="on")
            outs = {}
            for name, m, c in (
                    ("1dev", None, pcfg),
                    ("mesh", mesh, pcfg),
                    ("rowshard", mesh, dataclasses.replace(pcfg, graph_placement="rowshard"))):
                out = os.path.join(d, f"out_{name}.fa")
                res = run_pipeline(*args, out, c, mesh=m, device=dev)
                # a mesh run's file is written once per host; every rank holds the scaffolds
                outs[name] = (_read(out) if os.path.exists(out) else None,
                              [(s.name, np.asarray(s.seq).tobytes()) for s in res.scaffolds])
            for name in ("mesh", "rowshard"):
                same = outs[name][1] == outs["1dev"][1] and outs[name][0] in (None, outs["1dev"][0])
                if not same:
                    raise AssertionError(f"{name} pipeline FASTA diverged from the 1-device run")
            fasta_bytes = len(outs["1dev"][0])
            if fasta_bytes <= 0:
                raise AssertionError("pipeline wrote an empty FASTA")

        # per-shard balance table
        succ1, active = res_1.success.cpu().numpy(), np.asarray(plan.active)
        n_act = np.zeros(n_devices, np.int64)
        n_ok = np.zeros(n_devices, np.int64)
        for _kind, (lo, hi) in (plan.sections or {"all": (0, len(plan))}).items():
            per = (hi - lo) // n_devices
            for di in range(n_devices):
                sl = slice(lo + di * per, lo + (di + 1) * per)
                n_act[di] += int(active[sl].sum())
                n_ok[di] += int(succ1[sl].sum())
        summary = dict(devices=n_devices, device=str(dev), walks=len(plan), successful=n_succ,
                       bridges=n_bridge, fasta_bytes=fasta_bytes,
                       per_shard_active_successful=[f"{a}/{s}" for a, s in zip(n_act, n_ok)],
                       launches=launch_counts())
        if mesh.rank == 0:
            print(f"dryrun_multichip({n_devices}): {len(plan)} walks sharded over "
                  f"{n_devices} devices, {n_succ} successful, {n_bridge} bridges; "
                  f"walk table rebuilt from device scores bit-equal to the host's; "
                  f"walks+consensus byte-identical to 1-device on both placements; "
                  f"pipeline FASTA byte-identical (1dev == mesh == rowshard, "
                  f"{fasta_bytes} bytes); per-shard active/successful: "
                  f"{summary['per_shard_active_successful']}")
            print(json.dumps({"dryrun": summary}), flush=True)
        return summary
    finally:
        shutdown_distributed()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m telomeri_tpu_torch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, default=1, metavar="N",
                    help="world size: one process per device (default 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.mesh < 1:
        ap.error("--mesh must be at least 1")
    rc = check_devices_or_launch(ap, args.device, args.mesh, "telomeri_tpu_torch.dryrun",
                                 sys.argv[1:] if argv is None else argv)
    if rc is not None:
        return rc
    dryrun_multichip(args.mesh, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

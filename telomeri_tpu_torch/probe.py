"""Timing probe of the port on one device: where a scaffolding run's time goes.

    python -m telomeri_tpu_torch.probe --simulate ecoli --out probe.json
    python -m telomeri_tpu_torch.probe --data DIR [--device cuda] [--runs 3]

DIR holds contigs.fa, reads.fa, read2contig.paf and read2read.paf, the layout
that `telomeri-tpu-torch simulate` writes; with --simulate PRESET the probe
simulates the preset into a temporary directory first. The config is the
default ScaffoldConfig with device_scoring="on" (the path chip_smoke.py drives).
It prints one JSON object, and writes it to --out when given:

  runs     wall seconds, parser backend and stage seconds of `runs` run_pipeline
           calls in one warm process (one untimed run first builds the kernels
           and warms the allocator), with the median of each stage
  device   one more run under torch.profiler (CUDA only): device busy time as
           the sum of the device items' self time, its share of the run's wall
           time, and the largest device items
  cutover  the data for device_scoring="auto": at each edge count, build_edges'
           host numpy scorer against rescore_edges_device's round trip (upload
           the 8 geometry arrays, score on the device, copy 2 outputs back)

Every time is a median over repeats in this process; nothing is cached between
calls of the probe.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
CUTOVER_EDGES = (1_000, 10_000, 100_000, 552_256, 4_000_000, 32_000_000)


def _nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_runs(data_dir: str, device, runs: int = 3) -> dict:
    """`runs` timed run_pipeline calls after one untimed warm-up call."""
    from telomeri_tpu_torch.utils.logging import Metrics
    from telomeri_tpu_torch.pipeline import ScaffoldConfig, run_pipeline

    device = torch.device(device)
    cfg = ScaffoldConfig(device_scoring="on")
    paths = [os.path.join(data_dir, f) for f in INPUTS]
    walls, stages, backend = [], [], None
    for i in range(runs + 1):
        metrics = Metrics()
        t0 = time.perf_counter()
        run_pipeline(*paths, None, cfg, metrics, device=device)
        _sync(device)
        if i:
            walls.append(time.perf_counter() - t0)
            stages.append(dict(metrics.timings))
        backend = metrics.values.get("parser_backend")
    names = sorted({k for s in stages for k in s}, key=lambda k: -stages[0].get(k, 0.0))
    return dict(wall_s=walls, parser_backend=backend,
                stage_median_s={k: statistics.median(s.get(k, 0.0) for s in stages)
                                for k in names},
                stages_s=stages)


def device_profile(data_dir: str, device, top: int = 12) -> dict:
    """One run_pipeline call under torch.profiler: device busy time and share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from telomeri_tpu_torch.pipeline import ScaffoldConfig, run_pipeline

    device = torch.device(device)
    if device.type != "cuda":
        return dict(measured=False, reason="the profiler's device time needs a CUDA device")
    cfg = ScaffoldConfig(device_scoring="on")
    paths = [os.path.join(data_dir, f) for f in INPUTS]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pipeline(*paths, None, cfg, device=device)
        _sync(device)
        wall = time.perf_counter() - t0
    items = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    items.sort(key=lambda t: -t[1])
    busy_s = sum(t[1] for t in items) / 1e6
    return dict(measured=bool(items), wall_s=wall, busy_s=busy_s,
                busy_share=busy_s / wall, idle_share=1.0 - busy_s / wall,
                top=[dict(name=k[:120], ms=us / 1e3, count=c) for k, us, c in items[:top]])


def scoring_cutover(device, sizes=CUTOVER_EDGES, repeats: int = 5, seed: int = 0) -> list:
    """Host numpy scoring against the device rescore's round trip, per edge count."""
    from telomeri_tpu_torch.kernels.scoring import score_arrays_np, score_overlaps

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    rows = []
    for n in sizes:
        geom = [rng.integers(0, 20_000, n).astype(np.int32) for _ in range(8)]

        def host():
            score_arrays_np(*geom)

        def round_trip():   # the body of io.geometry.rescore_edges_device
            dev = [torch.from_numpy(a).to(device) for a in geom]
            os_, es2 = score_overlaps(*dev, outputs=2)
            os_.cpu().numpy(), es2.cpu().numpy()

        row = dict(edges=n)
        for name, fn in (("host_ms", host), ("device_round_trip_ms", round_trip)):
            fn()
            _sync(device)
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            row[name] = statistics.median(times)
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m telomeri_tpu_torch.probe",
                                 description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--data", help="dataset directory (simulate's layout)")
    src.add_argument("--simulate", metavar="PRESET", help="simulate this preset first")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: torch sees no CUDA device")

    with tempfile.TemporaryDirectory() as tmp:
        data = args.data
        if args.simulate:
            from telomeri_tpu_torch.cli.main import main as cli

            data = os.path.join(tmp, args.simulate)
            if cli(["simulate", "--preset", args.simulate, "--out", data]) != 0:
                raise RuntimeError(f"simulating {args.simulate} failed")
        out = dict(data=args.simulate or args.data, device=args.device,
                   gpu=_nvidia_smi() if args.device == "cuda" else None,
                   runs=pipeline_runs(data, args.device, args.runs),
                   device_profile=device_profile(data, args.device),
                   cutover=scoring_cutover(args.device))
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

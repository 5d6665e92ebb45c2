"""Benchmark of the port on one GPU: Monte-Carlo walks/s per GPU (primary) and
overlaps scored/s, the counterpart of the reference's bench.py.

    python -m telomeri_tpu_torch.bench [--device {cuda,cpu}]

Prints JSON lines on stdout, {"metric", "value", "unit", "vs_baseline", ...};
everything else goes to stderr. For the walk lines vs_baseline is the device's
walk-steps/s over the steps/s of the single-core scalar oracle (walk/oracle.py,
which does the same work per step) MEASURED IN THE SAME RUN on this machine's
host: no constant from another machine is carried. A failure raises and the
process exits non-zero; it runs on the CPU only when --device cpu is given.

The default run, in this order:
  1. the problem (a 400 kb, 6-copy simulation at 20x, max_steps 32) is built
     on the host and the oracle is timed on it (MC rows only, evenly spaced,
     at most 600, median of 3 passes);
  2. the small batch (BENCH_MC_WALKS MC walks per contig end, default 4096:
     about 49.6k walks): table and plan resident on the device, one untimed
     run_walks_prepared, then a burst of max(BENCH_REPEATS, 20) calls timed by
     one pair of CUDA events and one synchronize (the host's clock on the CPU);
     then, from a second short burst, the walk stage's three parts each on its
     own: the greedy section, the walk scan and the event resolution (on a
     card each one kernel), with the device launches of each part and of the
     whole call counted (stderr);
  3. the peak batch (BENCH_PEAK_MC_WALKS, default 131072: about 1.57M walks;
     0 leaves it out) the same way, and the 2-output scoring kernel on the
     problem's edge geometry tiled to BENCH_SCORING_ROWS rows (default 64M),
     1-D int32 tensors uploaded outside the timed region.

BENCH_SCALE selects another run instead:
  hg002-graph   a synthetic walk table at whole-human scale (BENCH_HG002_N
                oriented nodes, default 6,291,456, K = 64: 9.66 GB on the card)
                and 49,152 MC walks of 32 steps on it
  sweep         walks/s against the batch width W = 49,152 ... 786,432 on a
                synthetic table of 1,048,576 nodes (random access, the worst
                locality)
  ecoli-stages  where an end-to-end run's time goes on the simulated E. coli
                preset: stage seconds of warm run_pipeline calls, the device's
                busy share under torch.profiler, and host scoring against the
                device rescore's round trip per edge count
BENCH_SCALING=1 adds, after the small batch, the walk stage on worlds of 1, 2
and 4 GPUs (one process each, started by torch.distributed.run); with one
device it says so and goes on.
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

SIM = dict(genome_len=400_000, repeat_len=5_000, n_repeat_copies=6, read_len_mean=3_000,
           read_len_sd=500, coverage=20.0, error_rate=0.02, seed=12)
HG002_N = 6_291_456
SWEEP_N = 1_048_576
SWEEP_WIDTHS = (49_152, 98_304, 196_608, 393_216, 786_432)
SYNTH_K, SYNTH_ANCHORS, SYNTH_WALKS, SYNTH_STEPS = 64, 2000, 49_152, 32
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
CUTOVER_EDGES = (1_000, 10_000, 100_000, 552_256, 4_000_000, 32_000_000)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    """The GPU's name and power limit as nvidia-smi reports them (every number
    of a run stands beside them), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip()
            else torch.cuda.get_device_name(device))


def timed_ms(fn, calls: int, device: torch.device) -> float:
    """ms per call of fn() over a burst of `calls`, each result dropped at
    once: one pair of CUDA events and one synchronize on a GPU, the host's
    clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    with torch.cuda.device(device):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def emit(walks_per_s: float, steps_per_s: float, oracle: tuple[float, float], n_walks: int,
         device: str) -> dict:
    """One walk line on stdout. value: device walks/s. vs_baseline: device
    steps/s over the oracle's steps/s of this run (a per-step rate, so it does
    not depend on how long the sampled walks ran); vs_baseline_today: walks/s
    over the oracle's walks/s."""
    oracle_walks, oracle_steps = oracle
    line = {
        "metric": "mc_walks_per_s_per_gpu",
        "value": round(walks_per_s, 1),
        "unit": "walks/s",
        "vs_baseline": round(steps_per_s / oracle_steps, 2),
        "vs_baseline_today": round(walks_per_s / oracle_walks, 2),
        "oracle_today_walks_per_s": round(oracle_walks, 1),
        "oracle_today_steps_per_s": round(oracle_steps, 1),
        "device_steps_per_s": round(steps_per_s, 1),
        "batch_walks": n_walks,
        "device": device,
    }
    print(json.dumps(line), flush=True)
    return line


def build_problem(mc_walks_per_end: int, device_scoring: str = "auto", *, device="cuda"):
    from telomeri_tpu_torch.config import ScaffoldConfig
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs
    from telomeri_tpu_torch.sim import SimConfig, simulate, write_dataset
    from telomeri_tpu_torch.walk.plan import plan_walks

    cfg = ScaffoldConfig(mc_walks_per_end=mc_walks_per_end, max_steps=32,
                         device_scoring=device_scoring)
    t0 = time.perf_counter()
    sim = simulate(SimConfig(**SIM))
    with tempfile.TemporaryDirectory() as d:
        write_dataset(sim, d)
        contigs, reads, paf = load_inputs(*[os.path.join(d, f) for f in INPUTS])
    edges, graph = build_graph(contigs, reads, paf, cfg, device=device)
    plan = plan_walks(graph, cfg)
    log(f"problem built in {time.perf_counter()-t0:.1f}s: {graph.stats}, "
        f"{plan.n_active} walks")
    return cfg, edges, graph, plan


def device_launches(fn) -> int:
    """Device kernels that one call of fn() launches on the card: the
    kernel-launch calls (cudaLaunchKernel, cuLaunchKernel and their variants)
    that torch.profiler records on the host's side; copies and memsets are
    other calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "LaunchKernel" in e.name or "LaunchCooperative" in e.name)


def walk_sections_split(cfg, gd, sections, *, n_nodes: int, n_anchors: int, device,
                        calls: int = 3) -> dict:
    """The walk stage part by part, each in a burst of its own: the greedy
    (or mixed) section, the walk scan, and resolve_mc_events on the scan's
    records, with the memory event resolution takes at its peak and, on a
    card, the device launches of each part."""
    from telomeri_tpu_torch.kernels.walk_scan import walk_scan
    from telomeri_tpu_torch.walk.engine import resolve_mc_events, run_walks_kind

    device = torch.device(device)
    s, seed = cfg.max_steps, cfg.mc_seed
    out: dict = {}
    for kind, pd in sections:
        w = int(pd.start.shape[0])
        if kind != "mc":
            run = lambda: run_walks_kind(gd, pd, seed, n_anchors=n_anchors, max_steps=s, kind=kind)
            run()
            out[f"{kind}_walks"], out[f"{kind}_ms"] = w, timed_ms(run, calls, device)
            if device.type == "cuda":
                out[f"{kind}_launches"] = device_launches(run)
            continue
        picks = gd.picks if device.type == "cuda" else None   # built once, as the engine's
        recs = walk_scan(gd.wide, pd.start, pd.uid, seed, s, picks)
        out["mc_walks"] = w
        scan = lambda: walk_scan(gd.wide, pd.start, pd.uid, seed, s, picks)
        out["scan_ms"] = timed_ms(scan, calls, device)
        if device.type == "cuda":
            out["scan_launches"] = device_launches(scan)
        resolve = lambda: resolve_mc_events(pd, *recs, n_nodes=n_nodes, n_anchors=n_anchors,
                                            max_steps=s)
        if device.type == "cuda":
            _sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
            resolve()
            _sync(device)
            out["resolve_peak_mb"] = (torch.cuda.max_memory_allocated(device) - held) / 1e6
            out["records_mb"] = recs.numel() * 4 / 1e6
            out["resolve_launches"] = device_launches(resolve)
        else:
            resolve()
        out["resolve_ms"] = timed_ms(resolve, calls, device)
    return out


def bench_walks(cfg, graph, plan, repeats: int, device="cuda"):
    """(walks/s, walk-steps/s, the section split) of run_walks_prepared on a
    device-resident table and plan."""
    from telomeri_tpu_torch.kernels.walk_table import graph_to_device
    from telomeri_tpu_torch.walk.engine import prepare_plan_sections, run_walks_prepared

    device = torch.device(device)
    gd = graph_to_device(graph, device)
    sections = prepare_plan_sections(plan, device)   # plan upload once, not per call
    run = lambda seed: run_walks_prepared(
        gd, sections, seed, n_anchors=graph.n_anchors, max_steps=cfg.max_steps)
    t0 = time.perf_counter()
    res = run(cfg.mc_seed)
    n_succ = int(res.success.sum())
    log(f"walk first run (kernels built and loaded): {time.perf_counter()-t0:.1f}s; "
        f"{n_succ}/{plan.n_active} successful")
    del res

    burst = max(repeats, 20)
    seeds = iter(range(cfg.mc_seed + 1, cfg.mc_seed + 1 + burst))
    last = []

    def call():
        last[:] = [run(next(seeds))]   # the result before it is dropped here

    dt = timed_ms(call, burst, device) / 1e3
    total_steps = int(last[0].steps.sum())
    last.clear()
    walks_per_s = plan.n_active / dt
    steps_per_s = total_steps / dt
    log(f"walk amortized over {burst}: {dt*1e3:.2f} ms/call "
        f"-> {walks_per_s:,.0f} walks/s, {steps_per_s:,.0f} walk-steps/s")
    split = walk_sections_split(cfg, gd, sections, n_nodes=int(gd.wide.shape[0]),
                                n_anchors=graph.n_anchors, device=device)
    split["whole_ms"] = dt * 1e3
    if device.type == "cuda":
        split["whole_launches"] = device_launches(lambda: run(cfg.mc_seed))
    log("walk stage split, ms per call: " + json.dumps(
        {k: round(v, 4) if isinstance(v, float) else v for k, v in split.items()}))
    return walks_per_s, steps_per_s, split


def oracle_rows(plan, max_walks: int = 600) -> np.ndarray:
    """The plan rows the oracle walks: Monte-Carlo rows only, evenly spaced."""
    from telomeri_tpu_torch.walk.plan import MODE_MC

    idx = np.flatnonzero(plan.active & (plan.mode == MODE_MC))
    return idx[np.linspace(0, len(idx) - 1, min(max_walks, len(idx))).astype(int)]


def bench_oracle(cfg, graph, plan, budget_s: float = 18.0, max_walks: int = 600):
    """Single-core scalar baseline on the SAME graph and walk plan: (median
    walks/s, median steps/s) over 3 passes.

    MONTE-CARLO rows only — the device metric is dominated by the MC section
    (~97% of a production plan) and greedy oracle walks do different per-step
    work, so mixing modes would make vs_baseline depend on the sampling
    pattern. Each pass gets a fresh fast_choice_fn (the identical workload)
    and budget_s / 3 seconds at most."""
    from telomeri_tpu_torch.walk.oracle import fast_choice_fn, walk_oracle

    sel = oracle_rows(plan, max_walks)
    rates, step_rates = [], []
    for _ in range(3):
        choice = fast_choice_fn(cfg.mc_seed)  # fresh RNG: identical workload per pass
        t0 = time.perf_counter()
        n = n_steps = 0
        for i in sel:
            ow = walk_oracle(graph, int(plan.start[i]), int(plan.first_edge[i]),
                             int(plan.mode[i]), int(plan.uid[i]), cfg.max_steps,
                             choice)
            n += 1
            n_steps += ow.steps
            if time.perf_counter() - t0 > budget_s / 3:
                break
        dt = time.perf_counter() - t0
        rates.append(n / dt)
        step_rates.append(n_steps / dt)
    walks_per_s = float(np.median(rates))
    steps_per_s = float(np.median(step_rates))
    log(f"oracle baseline: median {walks_per_s:,.1f} MC walks/s over 3 passes "
        f"(single core; passes {[f'{r:,.0f}' for r in rates]})")
    log(f"oracle invariant: median {steps_per_s:,.0f} oracle-steps/s (passes "
        f"{[f'{r:,.0f}' for r in step_rates]}; {len(sel)} rows, max_steps={cfg.max_steps})")
    return walks_per_s, steps_per_s


def tiled_geometry(edges, rows: int, device) -> list[torch.Tensor]:
    """The edges' eight geometry columns, each tiled whole to about `rows`
    rows, as 1-D int32 tensors on `device`."""
    geom = []
    for a in edges.geom_args():   # one tiled column on the host at a time
        a = np.ascontiguousarray(a, dtype=np.int32)
        geom.append(torch.from_numpy(np.tile(a, max(1, rows // max(len(a), 1)))).to(device))
    return geom


def bench_scoring(edges, repeats: int, device="cuda", rows: int = 64_000_000,
                  geom: list[torch.Tensor] | None = None) -> dict:
    """The production rescore path (the 2-output kernel through
    kernels/scoring.py score_overlaps) on the edges' geometry tiled to about
    `rows` rows (`geom`, where the caller holds tiled_geometry's tensors
    already): uploaded outside the timed region, a burst of max(repeats, 10)
    calls. The baseline is the host's numpy scorer on the untiled edges, in
    the same run."""
    from telomeri_tpu_torch.kernels.scoring import score_arrays_np, score_overlaps

    device = torch.device(device)
    base = [np.ascontiguousarray(a, dtype=np.int32) for a in edges.geom_args()]
    if geom is None:
        geom = tiled_geometry(edges, rows, device)
    n = int(geom[0].shape[0])
    run = lambda: score_overlaps(*geom, outputs=2)
    run()
    _sync(device)
    burst = max(repeats, 10)
    ms = timed_ms(run, burst, device)
    ops = n / (ms / 1e3)
    t0 = time.perf_counter()
    for _ in range(3):
        score_arrays_np(*base)
    host_ops = len(base[0]) / ((time.perf_counter() - t0) / 3)
    log(f"scoring (2-out, {device.type}): {n:,} overlaps in {ms:.3f} ms "
        f"-> {ops/1e9:.2f} G overlaps/s ({ops*36/1e9:.0f} GB/s at the 36 B a row the "
        f"function must move); host numpy {host_ops/1e9:.3f} G overlaps/s")
    return dict(overlaps_per_s=ops, ms=ms, rows=n, host_overlaps_per_s=host_ops)


def _scaling_worker(device: str) -> int:
    """One rank of bench_scaling's world: the walk stage (sharded walks and the
    gathered consensus) of the small problem, timed on the host's clock
    between barriers."""
    import torch.distributed as dist

    from telomeri_tpu_torch.dist.mesh import (
        init_distributed,
        make_walk_mesh,
        run_walks_distributed,
        shutdown_distributed,
    )
    from telomeri_tpu_torch.walk.plan import plan_walks

    mc = int(os.environ.get("BENCH_MC_WALKS", "4096"))
    repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    init_distributed(device)
    try:
        mesh = make_walk_mesh(None, device)
        cfg, _, graph, _ = build_problem(mc, device=mesh.device)
        plan = plan_walks(graph, cfg, n_shards=mesh.size)
        run_walks_distributed(graph, plan, cfg, mesh)
        _sync(mesh.device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(repeats):
            run_walks_distributed(graph, plan, cfg, mesh)
        _sync(mesh.device)
        dist.barrier()
        dt = (time.perf_counter() - t0) / repeats
        if mesh.rank == 0:
            log(f"scaling {mesh.size} devices: {plan.n_active/dt:,.0f} walks/s")
            print(json.dumps({"metric": "walk_stage_walks_per_s", "value": round(
                plan.n_active / dt, 1), "unit": "walks/s", "devices": mesh.size,
                "batch_walks": plan.n_active, "device": device_label(mesh.device)}), flush=True)
    finally:
        shutdown_distributed()
    return 0


def bench_scaling(mc_walks_per_end: int, repeats: int, device="cuda", worlds=None) -> list[int]:
    """The walk stage on worlds of 1, 2 and 4 devices (BENCH_SCALING=1): one
    process per device under torch.distributed.run, each world a fresh set of
    processes. Only meaningful with more than one GPU; returns the worlds run."""
    from telomeri_tpu_torch.utils.launch import launch_ranks

    if worlds is None:
        n_dev = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        if n_dev < 2:
            log(f"scaling: only {n_dev} device, skipping")
            return []
        worlds = [n for n in (1, 2, 4) if n <= n_dev]
    for n in worlds:
        rc = launch_ranks(n, "telomeri_tpu_torch.bench",
                          ["--device", str(device), "--scaling-worker"],
                          BENCH_MC_WALKS=str(mc_walks_per_end), BENCH_REPEATS=str(repeats))
        if rc != 0:
            raise RuntimeError(f"scaling: the world of {n} exited {rc}")
    return list(worlds)


# --- synthetic tables ---------------------------------------------------------------

def host_memory_available() -> int | None:
    """Bytes of host memory the kernel counts as available (Linux), else None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def synthetic_table(rng, n: int, k: int = SYNTH_K, n_anchors: int = SYNTH_ANCHORS) -> np.ndarray:
    """The packed (N, 6H) int32 walk table of a random graph: the table the
    reference's hg002-graph bench and walk-batch sweep upload, from the same
    generator calls in the same order (deg, nbr, es, adv; os = es), so the same
    `rng` gives the same table.

    The reference makes five (N, K) arrays, then packs a copy; at N = 6.3M that
    is 8 GB of arrays beside the 9.66 GB table and the generator's 3.2 GB
    64-bit draws. Here each column block is written into the table as it is
    drawn, so the host holds the table, one draw and one mask (about 13.5 GB at
    that size); the values are the same."""
    from telomeri_tpu_torch.kernels.walk_table import (BLOCKS, PAD, blocks, lane_width,
                                                       mc_weights, table_shape)

    h = lane_width(k)
    if n * k >= 2**31 - 1:
        raise ValueError(f"edge ids of {n} x {k} slots do not fit int32")
    deg = rng.integers(4, k + 1, n).astype(np.int32)
    mask = np.arange(k, dtype=np.int32)[None, :] < deg[:, None]
    wide = np.empty(table_shape(n, h), np.int32)
    row = blocks(wide)
    for view, name in zip(row, BLOCKS):                          # slots past K
        view[:, k:] = PAD[name]                                  # (cum's: below)
    draw = rng.integers(2 * n_anchors, n, (n, k))
    draw[~mask] = -1
    row.nbr[:, :k] = draw
    es = rng.uniform(100, 5000, (n, k)).astype(np.float32)
    es[~mask] = 0
    row.es_bits[:, :k] = es.view(np.int32)
    row.os_bits[:, :k] = es.view(np.int32)
    step = max(1, 2**20 // k * 16)
    for lo in range(0, n, step):                                 # cum, a block of rows at a time
        hi = min(lo + step, n)
        cum = np.cumsum(mc_weights(es[lo:hi]), axis=1, dtype=np.int64)
        row.cum[lo:hi, :k] = cum
        row.cum[lo:hi, k:] = cum[:, -1:]                         # pads carry the row total
        eid = np.arange(lo * k, hi * k, dtype=np.int64).reshape(hi - lo, k)
        row.eid[lo:hi, :k] = np.where(mask[lo:hi], eid, -1)
    del es
    draw = rng.integers(100, 3000, (n, k))
    draw[~mask] = 0
    row.adv[:, :k] = draw
    return wide


def synthetic_plan(rng, w: int, device, n_anchors: int = SYNTH_ANCHORS):
    """W Monte-Carlo walks from random anchor ends, uids 0..W-1, on `device`."""
    from telomeri_tpu_torch.walk.engine import plan_to_device
    from telomeri_tpu_torch.walk.plan import MODE_MC, WalkPlan

    return plan_to_device(WalkPlan(
        start=rng.integers(0, 2 * n_anchors, w).astype(np.int32),
        first_edge=np.full(w, -1, np.int32), mode=np.full(w, MODE_MC, np.int32),
        uid=np.arange(w, dtype=np.int32), active=np.ones(w, bool)), device)


def _synthetic_walks(gd, pd, device, calls: int = 10) -> tuple[float, int]:
    """(seconds per call, walk-steps of the last call) of the MC section on a
    synthetic table: one untimed call, then `calls` with seeds 1, 2, ..."""
    from telomeri_tpu_torch.walk.engine import run_walks_kind

    run = lambda seed: run_walks_kind(gd, pd, seed, n_anchors=SYNTH_ANCHORS,
                                      max_steps=SYNTH_STEPS, kind="mc")
    run(0)
    seeds = iter(range(1, 1 + calls))
    last = []

    def call():
        last[:] = [run(next(seeds))]

    dt = timed_ms(call, calls, device) / 1e3
    return dt, int(last[0].steps.sum())


def hg002_host_bytes(n: int) -> int:
    """Host memory that building the N-node table takes at its peak: the
    table, one 64-bit draw, the mask, and 1 GiB beside them."""
    from telomeri_tpu_torch.kernels.walk_table import lane_width, nbytes, table_shape

    return nbytes(table_shape(n, lane_width(SYNTH_K))) + n * SYNTH_K * 9 + 2**30


def hg002_problem(device, n: int):
    """(table, plan) of the hg002-graph bench on `device`: N oriented nodes and
    SYNTH_WALKS MC walks from default_rng(0). MemoryError where the host
    cannot hold the table's build."""
    from telomeri_tpu_torch.kernels.walk_table import GraphDev, lane_width, nbytes, table_shape

    device = torch.device(device)
    table_bytes = nbytes(table_shape(n, lane_width(SYNTH_K)))
    need, free = hg002_host_bytes(n), host_memory_available()
    log(f"hg002 graph: N={n:,}, table {table_bytes/2**30:.2f} GiB; host memory available "
        f"{'unknown' if free is None else f'{free/2**30:.1f} GiB'}, needs about "
        f"{need/2**30:.1f} GiB")
    if free is not None and free < need:
        raise MemoryError(f"the host has {free/2**30:.1f} GiB available, the table's build "
                          f"needs about {need/2**30:.1f} GiB: lower BENCH_HG002_N")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    wide = synthetic_table(rng, n)
    log(f"hg002 graph built on host in {time.perf_counter()-t0:.0f}s")
    t0 = time.perf_counter()
    gd = GraphDev(wide=torch.from_numpy(wide).to(device))
    _sync(device)
    del wide
    log(f"upload {gd.wide.numel()*4/2**30:.1f} GiB in {time.perf_counter()-t0:.0f}s")
    return gd, synthetic_plan(rng, SYNTH_WALKS, device)


def hg002_walks(gd, pd, device) -> dict:
    """The hg002-graph line (printed on stdout) of a burst of the MC section
    on hg002_problem's table and plan."""
    device = torch.device(device)
    dt, steps = _synthetic_walks(gd, pd, device)
    w, n, gib = int(pd.start.shape[0]), int(gd.wide.shape[0]), gd.wide.numel() * 4 / 2**30
    log(f"hg002-scale walks: {dt*1e3:.2f} ms/call -> {w/dt:,.0f} walks/s/gpu, "
        f"{steps/dt:,.0f} walk-steps/s")
    line = {"metric": "hg002_scale_walks_per_s_per_gpu", "value": round(w / dt, 1),
            "unit": "walks/s", "vs_baseline": round(gib, 2), "table_gib": round(gib, 2),
            "nodes": n, "batch_walks": w, "device_steps_per_s": round(steps / dt, 1),
            "device": device_label(device)}
    print(json.dumps(line), flush=True)
    return line


def bench_hg002_graph(device="cuda", n: int | None = None) -> dict:
    """BENCH_SCALE=hg002-graph: a whole-human-scale walk table on one device and
    the walk throughput on it, with fully random access (no anchor locality: a
    worst case against real graphs)."""
    n = int(os.environ.get("BENCH_HG002_N", HG002_N)) if n is None else n
    gd, pd = hg002_problem(device, n)
    return hg002_walks(gd, pd, device)


def bench_sweep(device="cuda", n: int = SWEEP_N, widths=SWEEP_WIDTHS) -> list[dict]:
    """BENCH_SCALE=sweep: walks/s against the batch width W on a fixed
    synthetic table, to find where the batch size stops paying."""
    from telomeri_tpu_torch.kernels.walk_table import GraphDev

    device = torch.device(device)
    rng = np.random.default_rng(0)
    gd = GraphDev(wide=torch.from_numpy(synthetic_table(rng, n)).to(device))
    log(f"graph on device: N={n}, K={SYNTH_K}")
    label, rows = device_label(device), []
    for w in widths:
        pd = synthetic_plan(rng, w, device)
        dt, steps = _synthetic_walks(gd, pd, device)
        log(f"W={w:7d}: {dt*1e3:8.2f} ms/call  {w/dt/1e6:6.2f} M walks/s  "
            f"{steps/dt/1e6:7.1f} M walk-steps/s")
        rows.append({"metric": "sweep_walks_per_s_per_gpu", "value": round(w / dt, 1),
                     "unit": "walks/s", "batch_walks": w, "nodes": n,
                     "device_steps_per_s": round(steps / dt, 1), "device": label})
        print(json.dumps(rows[-1]), flush=True)
    return rows


# --- where an end-to-end run's time goes (BENCH_SCALE=ecoli-stages) ------------------

def pipeline_runs(data_dir: str, device, runs: int = 3) -> dict:
    """`runs` timed run_pipeline calls (default config plus device scoring)
    after one untimed warm-up call: wall seconds and stage seconds of each,
    and each stage's median."""
    from telomeri_tpu_torch.pipeline import ScaffoldConfig, run_pipeline
    from telomeri_tpu_torch.utils.logging import Metrics

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
    """One run_pipeline call under torch.profiler: the device's busy time as
    the sum of the device items' self time, its share of the run's wall time,
    and the largest device items."""
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
    """The data for device_scoring="auto": at each edge count, the host's numpy
    scorer against rescore_edges_device's round trip (upload the 8 geometry
    arrays, score on the device, copy 2 outputs back); medians, ms."""
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


def bench_ecoli_stages(device="cuda", data_dir: str | None = None, runs: int = 3) -> dict:
    """BENCH_SCALE=ecoli-stages: pipeline_runs, device_profile and
    scoring_cutover on the simulated E. coli preset (or the dataset directory
    BENCH_DATA: contigs.fa, reads.fa, read2contig.paf, read2read.paf); one
    JSON object on stdout."""
    device = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        data = data_dir
        if data is None:
            from telomeri_tpu_torch.cli.main import main as cli

            data = os.path.join(tmp, "ecoli")
            if cli(["simulate", "--preset", "ecoli", "--out", data]) != 0:
                raise RuntimeError("simulating the ecoli preset failed")
        out = dict(data=data_dir or "ecoli", device=device_label(device),
                   runs=pipeline_runs(data, device, runs),
                   device_profile=device_profile(data, device),
                   cutover=scoring_cutover(device))
    print(json.dumps(out), flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m telomeri_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device work runs (default cuda; never the CPU unasked)")
    ap.add_argument("--scaling-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: torch sees no CUDA device (use --device cpu)")
    if args.scaling_worker:
        return _scaling_worker(args.device)
    device = torch.device(args.device)
    label = device_label(device)
    log(f"device: {label}; torch {torch.__version__}")
    scale = os.environ.get("BENCH_SCALE")
    if scale == "hg002-graph":
        bench_hg002_graph(device)
        return 0
    if scale == "sweep":
        bench_sweep(device)
        return 0
    if scale == "ecoli-stages":
        bench_ecoli_stages(device, os.environ.get("BENCH_DATA"))
        return 0
    if scale:
        ap.error(f"BENCH_SCALE={scale!r}: expected hg002-graph, sweep or ecoli-stages")

    # 4096 MC/end -> ~49.6k walks, the production operating point; 131072 -> the
    # ~1.57M-walk peak batch
    mc_small = int(os.environ.get("BENCH_MC_WALKS", "4096"))
    mc_peak = int(os.environ.get("BENCH_PEAK_MC_WALKS", "131072"))
    repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    scoring_rows = int(os.environ.get("BENCH_SCORING_ROWS", "64000000"))

    # oracle first: host only (device_scoring="off": the scores are the host's)
    cfg, edges, graph, plan = build_problem(mc_small, device_scoring="off", device=device)
    oracle = bench_oracle(cfg, graph, plan)

    walks_per_s, steps_per_s, _ = bench_walks(cfg, graph, plan, repeats, device)
    emit(walks_per_s, steps_per_s, oracle, plan.n_active, label)
    if os.environ.get("BENCH_SCALING"):
        bench_scaling(mc_small, repeats, device)

    if mc_peak > mc_small:
        cfg, edges, graph, plan = build_problem(mc_peak, device=device)
        walks_per_s, steps_per_s, _ = bench_walks(cfg, graph, plan, repeats, device)
        emit(walks_per_s, steps_per_s, oracle, plan.n_active, label)
        s = bench_scoring(edges, repeats, device, rows=scoring_rows)
        print(json.dumps({
            "metric": "overlaps_scored_per_s", "value": round(s["overlaps_per_s"], 1),
            "unit": "overlaps/s",
            "vs_baseline": round(s["overlaps_per_s"] / s["host_overlaps_per_s"], 2),
            "host_numpy_overlaps_per_s": round(s["host_overlaps_per_s"], 1),
            "rows": s["rows"], "ms": round(s["ms"], 4), "device": label}), flush=True)
    else:
        log(f"[bench] peak batch left out (BENCH_PEAK_MC_WALKS={mc_peak})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

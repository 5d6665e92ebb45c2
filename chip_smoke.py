#!/usr/bin/env python3
"""Smoke run of telomeri_tpu_torch on one CUDA GPU (the quickest proof that the
port still builds, agrees with itself and scaffolds on the card).

    python3 chip_smoke.py    # from the root of a checkout; takes no arguments

Phases, one JSON line each; any failure raises and the exit code is not 0:
  0 device   needs torch.cuda; prints nvidia-smi's name and power limit
  1 build    nvcc builds csrc/*.cu for sm_90a from the checkout; then the
             latency of one dependent load, an L2 hit and a device-memory load
             (csrc/chase_probe.cu), for the greedy scan's chain bound
  2 scoring  both scoring kernels (4 and 2 outputs) bitwise equal to the plain
             torch version on the card and to the numpy oracle, n = 1 .. 64M
             (3, 5, 127 and 1,000,003 rows end in the scalar tail) and on
             contiguous views offset by 1 and 3 elements, with the instantiation
             each shape launched (vector: 16-byte loads; scalar: 4-byte); then,
             at the main path's 552,256 rows and at 64M rows, each kernel's
             device time (CUDA events around replays of a CUDA graph of its
             launches, with the L2 flushed before each launch and warm), the
             wrapper's host time per call, the plain version's time and the
             bound
  3 walks    simulates the E. coli preset (reused by phase 5) and the tandem
             array (reused by phase 7); on the lambda and E. coli graphs and at
             the rescue round's batch cap (2**20 walks) the three walk kernels
             are bitwise equal to their plain versions on the card (and, on
             lambda and E. coli, on the CPU): the fused walk scan's records (its
             plain version: the torch draw table, then the plain scan), the
             event resolution on them, the greedy scan on the greedy section and
             on the whole plan as a mixed one (at the cap, on greedy and mixed
             plans made from its starts); each kernel's time (device time, as
             in phase 2) and its plain version's beside its bound; the rescore
             kernel on the E. coli edges against the host's scores, and the
             rescore stage's split (upload, kernel, download, whole) as the
             package uploads and as one stacked transfer; the E. coli walk stage
             part by part (draw table, fused scan, event resolution, greedy
             section: ms and device launches each; the MC section is 2
             launches); the three kernels against their plain versions at 48,
             96, 512 (fewer walks a block) and odd step counts on the tandem
             table, with rescue uids and
             negative seeds, and at H = 128, 256, 512 and 1024 on synthetic hub
             rows; at E. coli one line each for the greedy scan's time a step
             beside one L2 hit and the resolution's time a walk-step
  4 lambda   run_pipeline on testdata/lambda with device scoring on the card:
             byte-identical to golden_scaffolds.fa, both path kernels launched
  5 ecoli    the CLI `scaffold --device cuda --device-scoring on` on the E. coli
             preset, validated against its genome (1 scaffold, n_placed == 1,
             mean identity > 0.98; metrics.json has the dispatch records); launch
             counts are zeroed just before and read just after this run
  6 mesh     the CLI under `python -m torch.distributed.run --nproc-per-node 1
             ... scaffold --mesh 1` on the same E. coli data, each FASTA
             byte-identical to phase 5's: replicated; (a) replicated with
             --save-graph, --save-walks and --trace (the trace must name the
             three walk kernels, and the walk stage is those kernels in a row,
             with no per-step stream of small kernels: the launch counts of a
             torchrun child are out of sight); (b) the
             row-sharded placement (NCCL all_gather / reduce_scatter every walk
             step), (c) resumed from (a)'s artifacts without the PAF files (the
             first two runs side by side, then (b) beside (c)); the walk
             stage's seconds of each run on its own line. Then lambda and
             E. coli through the library on a mesh of 1 (NCCL, this process) in
             both placements, byte-identical to golden_scaffolds.fa and phase 5,
             the walk-scan and greedy-scan kernels launched on the replicated
             mesh path and not on the row-sharded one (whose scans fetch rows
             with collectives), the event resolution on both; and the per-step
             cost of the row-sharded fetch
             against a local row gather on the E. coli MC section. With two
             (four) or more cards, both placements again at --nproc-per-node 2
             (and 4), byte-identical too.
  7 scenarios  tests/test_scale.py's tandem array at 48 and 96 steps (score_sum
             in XLA's windowed order) and its under-sampled gap with the rescue
             round off and on (polish on), each through run_pipeline on the card
             and on the CPU in this process: byte-identical FASTA, equal walk
             records (score_sum by its bits), representatives and counters; the
             reference test's pairs; every path kernel launched in each run, the
             walk scan more often with the rescue round on;
             `python -m telomeri_tpu_torch.gap_report --device cuda` (its
             consensus replayed on the card) on the card's artifacts of the
             missed gap printing the same report as `diagnose(device="cuda")`
             in this process on the CPU's
  8 bench    telomeri_tpu_torch.bench in this process: the host oracle (its
             budget cut from 18 s to 6 s), the small (about 49.6k walks) and the
             peak (about 1.57M walks) batch with the walk stage's split (greedy
             section, walk-scan kernel, event resolution; the first and the
             last one device launch each), the 2-output scoring
             kernel at 64M rows, and the whole-human-scale table (6,291,456
             nodes, 9.66 GB; a smaller N, printed, where the host's memory does
             not allow it). Launch counts are zeroed before each part and read
             after it, and each part's own count stands in its row of the
             kernels line. After each part its kernels are held to their plain
             versions at the part's shape and on the part's inputs, every walk
             or row by its bits, and timed there (kernel_times): the walk scan
             and the event resolution on the small and the peak cell's MC
             section and on the whole-human-scale table (row offsets past 2**31
             words), the greedy scan on the small and the peak cell's greedy
             section, the 2-output scoring kernel on the bench's tiled 64M-row
             geometry
  9 chunked  the E. coli plan through run_walks_host and the pipeline's consensus
             unchunked and with max_walk_batch 8192 (records back on the host,
             summarized chunk by chunk): records and consensus bit-equal, and
             the peak device memory of the walk stage and of the consensus for
             both
 10 dryrun   `python -m telomeri_tpu_torch.dryrun --device cuda` at a world of 1
             (and of 2 with two cards): device rescoring -> rebuilt walk table
             -> sharded walks -> gathered consensus -> FASTA, equal across one
             device, the replicated mesh and the row-sharded placement
 11 multi_card  with two or more cards: `scaffold --mesh 2` started with no
             launcher, with --save-walks; FASTA byte-identical to phase 5's and
             the saved records equal to the one-device artifact's. With one
             card it prints that this was not run and why
 12 native   `python -m telomeri_tpu_torch.native.build` (g++), then the E. coli
             CLI run in a fresh process with parser_backend == "native": FASTA
             byte-identical to phase 5's (the Python parsers), parse_paf and
             load_sequences seconds of both
Then neither telomeri_tpu nor jax may be in sys.modules; the kernels' summary
line (time, plain time, bound and launches of each on the E. coli scaffold
path, then of each bench part's kernel at that part's shape), and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
SOURCES = {   # for the walk kernels with no Pallas twin: the reference function they replace
    "walk_scan": ("telomeri_tpu_torch/csrc/walk_scan.cu",
                  "telomeri_tpu/kernels/walk_vmem.py:61"),
    "greedy_scan": ("telomeri_tpu_torch/csrc/greedy_scan.cu",
                    "telomeri_tpu/walk/engine.py:401"),
    "resolve_events": ("telomeri_tpu_torch/csrc/walk_events.cu",
                       "telomeri_tpu/walk/engine.py:313"),
    "score_os_es2": ("telomeri_tpu_torch/csrc/scoring.cu",
                     "telomeri_tpu/kernels/scoring.py:86"),
    "score_overlaps": ("telomeri_tpu_torch/csrc/scoring.cu",
                       "telomeri_tpu/kernels/scoring.py:65"),
}
WALK_KERNELS = ("greedy_scan", "walk_scan", "resolve_events")   # the walk stage, in order
PATH_KERNELS = (*WALK_KERNELS, "score_os_es2")   # what the scaffold path launches
FIELDS = ("nodes", "eids", "steps", "success", "terminal", "path_len", "score_sum")
DEVICE = "cuda"
ECOLI_EDGES = 552_256   # the main path's scoring shape (phase 3 checks the count)
# the timed shapes first: they are timed before this process first profiles
SCORING_ROWS = (ECOLI_EDGES, 64 * 2**20, 1, 3, 5, 127, 1000, 1_000_003)
SCORING_OFFSET_ROWS = (5, 127, 1_000_003)   # also scored on views a[1:] and a[3:]
SCORING_TIMED_ROWS = (ECOLI_EDGES, 64 * 2**20)
SCORING_KERNELS = ((2, "score_os_es2"), (4, "score_overlaps"))
L2_FLUSH_BYTES = 128 * 2**20   # the H100's L2 holds 50 MB

# phase 7: tests/test_scale.py's datasets as `simulate` flags, and its configs
SCENARIO_SIMS = {
    "tandem": ["--genome-len", "260000", "--repeat-len", "4000", "--n-repeat-copies", "6",
               "--tandem-pairs", "2", "--read-len-mean", "2500", "--read-len-sd", "300",
               "--read-min-len", "800", "--coverage", "24", "--error-rate", "0.005",
               "--ins-rate", "0.0025", "--del-rate", "0.0025", "--end-jitter", "10",
               "--min-sim-overlap", "300", "--cross-copy-overlaps", "true",
               "--copy-divergence", "0.04", "--seed", "22"],
    "rescue": ["--genome-len", "220000", "--repeat-len", "12000", "--n-repeat-copies", "3",
               "--read-len-mean", "2200", "--read-len-sd", "300", "--coverage", "14",
               "--error-rate", "0.02", "--cross-copy-overlaps", "true",
               "--copy-divergence", "0.02", "--seed", "2"],
}
_CORRECTED = dict(mc_walks_per_end=400, min_identity=0.97)
_RESCUE = dict(mc_walks_per_end=3, max_steps=32, rescue_walks_per_end=800, polish=True)
SCENARIOS = (   # name, dataset, config, accepted pairs (rescue_r0 misses gap 2)
    ("tandem_s48", "tandem", dict(_CORRECTED, max_steps=48), {(0, 2), (2, 4), (4, 6), (6, 8)}),
    ("tandem_s96", "tandem", dict(_CORRECTED, max_steps=96), {(0, 2), (2, 4), (4, 6), (6, 8)}),
    ("rescue_r0", "rescue", dict(_RESCUE, rescue_rounds=0), {(0, 2), (2, 4)}),
    ("rescue_r1", "rescue", dict(_RESCUE, rescue_rounds=1), {(0, 2), (2, 4), (4, 6)}),
)


_T0 = time.perf_counter()


def emit(phase: str, **kv) -> None:
    """One JSON line; t_s is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 1), **kv}),
          flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def paired_ms(kernel, plain, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _profiled(fn):
    """fn() under torch.profiler (host and device activity); its events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def kernel_names(fn, kernel: str) -> set[str]:
    """Names of the device kernels containing `kernel` that fn() launched, as
    torch.profiler (CUPTI) names them on the card. Used to name a launch, never
    to time or count it: device records can go missing in this process (the
    host's launch records do not, and bench.device_launches counts those), so a
    window in which none arrived is run again."""
    from torch.autograd import DeviceType

    for _ in range(3):
        names = {e.name for e in _profiled(fn)
                 if e.device_type == DeviceType.CUDA and kernel in e.name}
        if names:
            break
    return names


def graph_ms(body, replays: int = 10) -> float:
    """Device time, ms, of one replay of a CUDA graph that captured body() once:
    CUDA events around each of `replays` replays (3 where one takes over 10 ms)
    after an untimed one, the median. The card runs the captured launches with
    no Python between them."""
    import statistics

    import torch

    body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.01:   # a long graph spreads little
        replays = 3
    ms = []
    for _ in range(replays):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        ms.append(t0.elapsed_time(t1))
    del graph
    return statistics.median(ms)


TIMING = ("CUDA events around replays of a CUDA graph (median of 10 replays, of 3 above 10 ms). ms: L2 flushed, "
          f"a graph of 20 x ({L2_FLUSH_BYTES >> 20} MB write, launch) less a graph of the 20 "
          "writes, over 20; ms_warm: back to back, a graph of 40 launches less one of 20, over 20")


def device_ms(fn, launches: int = 20) -> tuple[float, float]:
    """(flushed, warm) device time in ms of the one kernel that fn() launches,
    not the pace of the Python around it (TIMING says how). Flushed: before
    every launch a write pass over a scratch tensor larger than the L2, so the
    kernel's inputs come from device memory, as the bound counts them."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)

    def rep(k: int, flush: bool, launch: bool):
        def body():
            for _ in range(k):
                if flush:
                    scratch.zero_()
                if launch:
                    fn()
        return graph_ms(body)

    flushed = (rep(launches, True, True) - rep(launches, True, False)) / launches
    warm = (rep(2 * launches, False, True) - rep(launches, False, True)) / launches
    return flushed, warm


def wrapper_host_us(fn, calls: int, repeats: int = 5) -> float:
    """Host time of one wrapper call, in microseconds: `calls` calls and one
    synchronize on the host's clock, over the calls; the median of `repeats`
    loops. Where the kernel outlasts its wrapper this is the card's pace."""
    import statistics

    import torch

    fn()
    us = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(us)


def kernel_times(fn, plain, bound: dict, iters: int) -> dict:
    """The readings of one kernel at one shape: ms (the number the kernels line
    reports) and ms_warm from device_ms, the wrapper's host time per call, the
    plain version's time (CUDA events around a loop) and the bound."""
    ms, ms_warm = device_ms(fn)
    return dict(ms=ms, ms_warm=ms_warm, wrapper_host_us=wrapper_host_us(fn, 8 * iters),
                plain_ms=cuda_ms(plain, iters), share_of_bound=bound["bound_ms"] / ms,
                **bound, timing=TIMING)


def _together(a, b):
    """a and b on one device: the card where either lies there."""
    dev = a.device if a.is_cuda else b.device
    return a.to(dev), b.to(dev)


def same_bits(a, b) -> bool:
    import torch

    a, b = _together(a, b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the elements (0.0 for empty tensors)."""
    a, b = _together(a, b)
    d = (a.double() - b.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and bound_by of one kernel call: the larger of its bytes over
    the memory rate and its operations over the peak rate (the H100's,
    benchmark/roofline.py)."""
    from benchmark import roofline

    t, by = roofline.bound_s(n_bytes, n_ops)
    return dict(bound_ms=t * 1e3, bound_by=by, bound_bytes=n_bytes)


# --- phases --------------------------------------------------------------------

def phase_device() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(line, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))


def phase_build() -> None:
    from telomeri_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.load()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(build.build_seconds, 3), library=os.path.relpath(path, ROOT),
         ptxas=ptxas)
    LOAD_NS.update(load_latency_ns())
    emit("load_latency", **LOAD_NS, probe="telomeri_tpu_torch/csrc/chase_probe.cu",
         note="one thread following a random cycle: 2**18 int32 (L2 hits after a first "
              "pass), 2**27 int32 (512 MiB, device memory); mean ns a hop")


LOAD_NS: dict = {}   # phase_build's dependent-load latencies, for the greedy chain bound


def load_latency_ns() -> dict:
    """ns of one dependent load on the card, by csrc/chase_probe.cu (one thread
    following a random cycle through an int32 array): over 2**18 entries (1
    MiB, L2 hits after an untimed full pass) and over 2**27 (512 MiB, ten L2s:
    each timed run follows a part of the cycle no earlier run touched, so every
    hop is a device-memory load); the mean over the hops of 3 timed runs."""
    import torch

    from telomeri_tpu_torch.kernels import build

    lib = build.load()
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    out = {}
    for name, n, hops in (("l2_ns", 2**18, 2**18), ("hbm_ns", 2**27, 2**17)):
        perm = torch.randperm(n, device=DEVICE, generator=gen)
        nxt = torch.empty(n, dtype=torch.int32, device=DEVICE)
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        end = torch.empty(1, dtype=torch.int32, device=DEVICE)
        starts = perm[::hops].tolist()   # parts of the cycle, one a run
        starts = iter(starts[:1] * 4 if name == "l2_ns" else starts)   # L2: all of it, each run

        def chase():
            build.check(lib.telomeri_chase(nxt.data_ptr(), next(starts), hops, end.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream), "chase")

        out[name] = cuda_ms(chase, 3) * 1e6 / hops
        del perm, nxt
    return out


def _geometry(rng, n: int):
    """Eight int32 geometry columns of n rows; above 2**22 rows a random block
    of that many, repeated."""
    import numpy as np

    rows, n = n, min(n, 2**22)
    g = [rng.integers(0, 5000, n), rng.integers(0, 6000, n), rng.integers(0, 6000, n),
         rng.integers(0, 6000, n), rng.integers(0, 2000, n), rng.integers(0, 2000, n),
         rng.integers(-30000, 30000, n), rng.integers(-30000, 30000, n)]
    g = [a.astype(np.int32) for a in g]
    if n >= 8:   # edge cases: bl = 0, values above 2**24, extreme negatives
        g[1][:4] = 0
        big = rng.integers(2**24, 2**31 - 1, n // 4, dtype=np.int64).astype(np.int32)
        for a in (g[0], g[2], g[6], g[7]):
            a[: len(big)] = big
        g[6][-4:] = -(2**31) + 1
    return g if rows == n else [np.resize(a, rows) for a in g]


def _scoring_row_bytes(outputs: int) -> int:
    """The bytes the function must move per row: the int32 columns its outputs
    depend on (all 8 with 4 outputs; 7 with 2, where nothing depends on el1)
    and `outputs` float32 columns."""
    return 4 * (8 if outputs == 4 else 7) + 4 * outputs


def _scoring_bound(n: int, outputs: int) -> dict:
    """Each needed column read once, each output written once; about 12
    float32 operations a row."""
    return _bound(n * _scoring_row_bytes(outputs), n * 12)


def _score_instantiation(kernel_name: str) -> str:
    """Which of csrc/scoring.cu's two kernels a launch was."""
    for tag, inst in (("score_kernel_vec", "vector"), ("score_kernel_scalar", "scalar")):
        if tag in kernel_name:
            return inst
    raise AssertionError(f"not a scoring kernel of csrc/scoring.cu: {kernel_name}")


def scoring_times(geom, results: dict) -> None:
    """Both scoring kernels on the geometry tensors (on the card): kernel_times."""
    from telomeri_tpu_torch.kernels import scoring

    n = int(geom[0].shape[0])
    for outputs, name in SCORING_KERNELS:
        t = kernel_times(lambda: scoring.score_overlaps_cuda(*geom, outputs=outputs),
                         lambda: scoring.score_overlaps_torch(*geom, outputs=outputs),
                         _scoring_bound(n, outputs), 20 if n < 2**24 else 5)
        results.setdefault(f"{name}@{n}", {}).update(t)
        emit("scoring_time", kernel=name, rows=n, bytes_per_row=_scoring_row_bytes(outputs), **t)


def phase_scoring(results: dict) -> None:
    import numpy as np
    import torch

    from telomeri_tpu_torch.kernels import scoring

    rng = np.random.default_rng(2026)
    cases = [(n, 0) for n in SCORING_ROWS] + [(n, k) for n in SCORING_OFFSET_ROWS for k in (1, 3)]
    checked = []
    for n, offset in cases:
        full = _geometry(rng, n + offset)   # the views a[offset:] are scored
        want = [torch.from_numpy(a) for a in scoring.score_arrays_np(*[a[offset:] for a in full])]
        geom = [torch.from_numpy(a).to(DEVICE)[offset:] for a in full]
        require(all(a.is_contiguous() and (a.data_ptr() % 16 == 0) == (offset == 0)
                    for a in geom), f"scoring n={n} offset={offset}: unexpected alignment")
        for outputs, name in SCORING_KERNELS:
            cols = (0, 1, 2, 3) if outputs == 4 else (1, 3)
            what = f"scoring n={n} offset={offset} outputs={outputs}"
            got = scoring.score_overlaps_cuda(*geom, outputs=outputs)
            plain = scoring.score_overlaps_torch(*geom, outputs=outputs)
            torch.cuda.synchronize()
            err = max(max_abs_err(k, p) for k, p in zip(got, plain))
            for c, k, p in zip(cols, got, plain):
                require(k.shape == p.shape and k.dtype == p.dtype and k.is_contiguous(),
                        f"{what} col {c}: the kernel's output is not laid out as the plain one")
                require(same_bits(k, p), f"{what} col {c}: kernel != plain (max abs err {err})")
                require(same_bits(k, want[c]), f"{what} col {c}: kernel != numpy")
            checked.append(dict(rows=n, offset=offset, outputs=outputs, max_abs_err=err))
            if (n, offset) == (ECOLI_EDGES, 0):
                results[f"{name}@{n}"] = dict(max_abs_err=err)
        if n in SCORING_TIMED_ROWS and not offset:
            scoring_times(geom, results)
        # which of the two kernels the launcher took, by the names the card ran
        inst = sorted({_score_instantiation(k) for k in kernel_names(
            lambda: [scoring.score_overlaps_cuda(*geom, outputs=o) for o in (2, 4, 2, 4)],
            "score_kernel")})
        require(inst == ["scalar" if offset else "vector"],
                f"scoring n={n} offset={offset} launched {inst}")
        for c in checked[-len(SCORING_KERNELS):]:
            c["instantiation"] = inst[0]
        del geom, want
    emit("scoring", ok=True, bitwise_equal=checked)


def _mc_inputs(graph, plan, device):
    from telomeri_tpu_torch.kernels.walk_table import graph_to_device

    return graph_to_device(graph, device), _section(plan, "mc", device)


def _plain_scan(wide, start, uid, seed, s):
    """The fused kernel's plain version: the draw table, then the plain scan."""
    from telomeri_tpu_torch.kernels import walk_scan
    from telomeri_tpu_torch.kernels.walk_common import stable_bits_table

    return walk_scan.walk_scan_torch(wide, start, stable_bits_table(seed, uid, s), s)


def _outputs_equal(name: str, kern, plain) -> float:
    """Seven WalkResult fields of a kernel and of its plain version equal by
    their bits (after a synchronize); the max abs err over them."""
    import torch

    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(kern, plain))
    for f, a, b in zip(FIELDS, kern, plain):
        require(a.dtype == b.dtype and same_bits(a, b),
                f"{name}: {f} differs from the plain version (max abs err {err})")
    return err


def _resolve_equals_plain(name, pd, recs, s, n_anchors, n_nodes):
    """The event-resolution kernel against its plain version on the same
    records; (max abs err, the kernel's walks)."""
    from telomeri_tpu_torch.kernels import walk_events
    from telomeri_tpu_torch.walk.engine import WalkResult

    kern = walk_events.resolve_events_cuda(pd.start, pd.active, *recs, n_anchors=n_anchors,
                                           max_steps=s)
    plain = walk_events.resolve_events_torch(pd.start, pd.active, *recs, n_nodes=n_nodes,
                                             n_anchors=n_anchors, max_steps=s)
    return _outputs_equal(f"{name} resolve_events", kern, plain), WalkResult(*kern)


def _scan_equals_plain(name, wide, pd, seed, s, n_anchors):
    """The fused kernel's records held by their bits against the plain
    version's on the card, then the event-resolution kernel on them against
    its plain version; (kernel records, scan max abs err, resolved walks,
    resolution max abs err)."""
    import torch

    from telomeri_tpu_torch.kernels import walk_scan

    kern = walk_scan.walk_scan_cuda(wide, pd.start, pd.uid, seed, s)
    plain = _plain_scan(wide, pd.start, pd.uid, seed, s)
    torch.cuda.synchronize()
    err = max_abs_err(kern, plain)
    require(same_bits(kern, plain), f"{name}: walk-scan records differ from the plain scan "
                                    f"(max abs err {err})")
    del plain
    res_err, res = _resolve_equals_plain(name, pd, kern, s, n_anchors, int(wide.shape[0]))
    return kern, err, res, res_err


def _greedy_equals_plain(name, wide, pd, seed, s, n_anchors, kind):
    """The greedy-scan kernel against its plain loop (local fetch) on the card;
    (max abs err, the kernel's walks)."""
    from telomeri_tpu_torch.kernels import greedy_scan
    from telomeri_tpu_torch.walk.engine import WalkResult

    kern = greedy_scan.greedy_scan_cuda(wide, pd, seed, n_anchors, s, kind)
    plain = greedy_scan.greedy_scan_torch(wide, pd, seed, n_anchors, s, kind)
    return _outputs_equal(f"{name} greedy_scan {kind}", kern, plain), WalkResult(*kern)


def _greedy_plans(pd, h: int):
    """A greedy and a mixed plan on an MC section's starts and uids: greedy
    walks by OS and by ES in turn, every third one with a forced first edge
    (some past the row's H slots); mixed adds MC walks (first_edge -1)."""
    import torch

    i = torch.arange(pd.start.shape[0], dtype=torch.int32, device=pd.start.device)
    first = torch.where(i % 3 == 0, (i // 3) % (h + 4), -1).to(torch.int32)
    return (pd._replace(mode=i % 2, first_edge=first),
            pd._replace(mode=i % 3, first_edge=torch.where(i % 3 == 2, -1, first)))


def _scan_bound(kern, wide, pd, s) -> dict:
    """The least time the card could take for this scan, from this run's data:
    benchmark/roofline.py scan_need of the distinct rows visited and the
    distinct (row, edge) picks of its records."""
    import torch

    from benchmark import roofline
    from telomeri_tpu_torch.kernels.walk_table import table_h

    seq = torch.cat([pd.start[:, None], kern[0][:, :-1]], dim=1).long()   # (W, S)
    col = torch.arange(s, device=seq.device)[None, :].expand_as(seq)
    last = torch.cummax(torch.where(seq >= 0, col, 0), dim=1).values   # a pad slot stays put
    counter = roofline.ScanCounter(int(wide.shape[0]), seq.device)
    counter.add(seq.gather(1, last), kern[2])
    rows, picks = counter.counts()
    need = roofline.scan_need(int(pd.start.shape[0]), s, table_h(wide), rows, picks)
    return dict(_bound(*need), rows_visited=rows, picks=picks)


def _resolve_bound(res, pd, s) -> dict:
    """The least time for this event resolution, from this run's data
    (benchmark/roofline.py resolve_need), and beside it the all-planes count:
    every record read once."""
    from benchmark import roofline

    w = int(pd.start.shape[0])
    all_planes = roofline.resolve_all_planes_bytes(w, s)
    return dict(_bound(*roofline.resolve_need(w, s, res.steps, res.success, pd.active)),
                all_planes_bytes=all_planes,
                all_planes_bound_ms=all_planes / roofline.HBM_BYTES_PER_S * 1e3)


def _greedy_bound(res, pd, h: int, s: int) -> dict:
    """The least time for this greedy section (modes 0 and 1), from this run's
    data, by bytes and operations: start, first_edge, mode and active read once
    (13 B a walk); the nbr block of every distinct row a walk fetched, and the
    OS key block of every distinct row a mode-0 walk fetched; eid, adv and es of
    every distinct edge taken; the outputs written once; H slot tests against
    each path entry so far at every step run. Beside it chain_ms: a walk's row
    fetches form a chain (the next row is the node just picked), so no walk
    ends before its steps run x one L2 hit's latency (LOAD_NS, this run's),
    counting one dependent load a step (the kernel makes two: the row, then
    the picked words). The chain binds where chain_ms is the larger."""
    import torch

    from benchmark.roofline import walk_output_bytes

    w = int(pd.start.shape[0])
    steps = res.steps.long()
    ran = torch.where(pd.active, torch.clamp(steps + (~res.success).long(), max=s), 0)
    fetched = torch.arange(s + 1, device=steps.device)[None, :] < ran[:, None]   # row of step t
    rows = int(torch.unique(res.nodes[fetched]).numel())
    os_rows = int(torch.unique(res.nodes[fetched & (pd.mode == 0)[:, None]]).numel())
    edges = int(torch.unique(res.eids[res.eids >= 0]).numel())
    n_bytes = 13 * w + (rows + os_rows) * h * 4 + 12 * edges + walk_output_bytes(w, s)
    chain = int(ran.max()) if w else 0
    return dict(_bound(n_bytes, h * int((ran * (ran + 1) // 2).sum())), rows_fetched=rows,
                os_rows_fetched=os_rows, edges_taken=edges, chain_steps=chain,
                chain_ms=chain * LOAD_NS["l2_ns"] * 1e-6, l2_load_ns=LOAD_NS["l2_ns"],
                hbm_load_ns=LOAD_NS["hbm_ns"])


def _build(data_dir: str, cfg):
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs, plan_walks

    contigs, reads, paf = load_inputs(*[os.path.join(data_dir, f) for f in INPUTS])
    edges, graph = build_graph(contigs, reads, paf, cfg, device=DEVICE)
    return edges, graph, plan_walks(graph, cfg)


def _section(plan, kind: str, device):
    from telomeri_tpu_torch.walk import engine

    lo, hi = plan.sections[kind]
    return engine.plan_to_device(engine._slice_plan(plan, lo, hi), device)


def _check_walk_scan(name, graph, plan, cfg, results, cpu_check: bool = True,
                     split: bool = False) -> None:
    """One graph's walk stage: the fused scan and the event resolution on the
    MC section, the greedy scan on the greedy section and the whole plan as a
    mixed one (or, for an all-MC plan, on _greedy_plans of it), each kernel
    against its plain version (and the CPU), with its time beside the plain
    version's and its bound, and the MC section's time. split: also the
    section part by part, with launch counts."""
    from telomeri_tpu_torch.bench import device_launches
    from telomeri_tpu_torch.kernels import greedy_scan, walk_events, walk_scan, walk_table
    from telomeri_tpu_torch.kernels.walk_common import stable_bits_table
    from telomeri_tpu_torch.walk import engine

    gd, pd = _mc_inputs(graph, plan, DEVICE)
    s, seed, w, na = cfg.max_steps, cfg.mc_seed, pd.start.shape[0], graph.n_anchors
    n_nodes = int(gd.wide.shape[0])
    kern, err, res_k, res_err = _scan_equals_plain(name, gd.wide, pd, seed, s, na)
    lo, hi = plan.sections["greedy"]
    if hi > lo:
        pg, pm = _section(plan, "greedy", DEVICE), engine.plan_to_device(plan, DEVICE)
    else:
        pg, pm = _greedy_plans(pd, gd.h)
    g_err, g_res = _greedy_equals_plain(name, gd.wide, pg, seed, s, na, "greedy")
    m_err, _ = _greedy_equals_plain(name, gd.wide, pm, seed, s, na, "mixed")
    if cpu_check:
        gd_c, pd_c = _mc_inputs(graph, plan, "cpu")
        cpu = walk_scan.walk_scan(gd_c.wide, pd_c.start, pd_c.uid, seed, s)
        require(same_bits(kern, cpu), f"{name}: walk-scan records differ from the CPU scan")
        res_c = engine.resolve_mc_events(pd_c, *cpu, n_nodes=n_nodes, n_anchors=na, max_steps=s)
        for f, a, b in zip(FIELDS, res_k, res_c):
            require(same_bits(a, b), f"{name}: resolved {f} differs (CPU)")
        g_c = engine.run_walks_kind(gd_c, _section(plan, "greedy", "cpu"), seed, n_anchors=na,
                                    max_steps=s, kind="greedy")
        for f, a, b in zip(FIELDS, g_res, g_c):
            require(same_bits(a, b), f"{name}: greedy {f} differs (CPU)")
    picks = gd.picks   # built here, before any timing or graph capture
    scan = lambda: walk_scan.walk_scan_cuda(gd.wide, pd.start, pd.uid, seed, s, picks=picks)
    resolve = lambda: walk_events.resolve_events_cuda(pd.start, pd.active, *kern, n_anchors=na,
                                                      max_steps=s)
    greedy = lambda: greedy_scan.greedy_scan_cuda(gd.wide, pg, seed, na, s, "greedy")
    section = lambda: engine.run_walks_mc(gd, pd, seed, n_anchors=na, max_steps=s)
    t = kernel_times(scan, lambda: _plain_scan(gd.wide, pd.start, pd.uid, seed, s),
                     _scan_bound(kern, gd.wide, pd, s), 5)
    t_res = kernel_times(resolve, lambda: walk_events.resolve_events_torch(
        pd.start, pd.active, *kern, n_nodes=n_nodes, n_anchors=na, max_steps=s),
        _resolve_bound(res_k, pd, s), 5)
    t_greedy = kernel_times(greedy, lambda: greedy_scan.greedy_scan_torch(
        gd.wide, pg, seed, na, s, "greedy"), _greedy_bound(g_res, pg, gd.h, s), 5)
    section_ms = cuda_ms(section, 5)
    results[f"walk_scan@{name}"] = dict(max_abs_err=err, **t)
    results[f"resolve_events@{name}"] = dict(max_abs_err=res_err, **t_res)
    results[f"greedy_scan@{name}"] = dict(max_abs_err=max(g_err, m_err), **t_greedy)
    emit("walk_scan", graph=name, walks=w, max_steps=s, h=gd.h, nodes=n_nodes,
         table_mb=walk_table.device_table_bytes(graph) / 1e6,
         walks_per_s=w / (t["ms"] / 1e3), plain_walks_per_s=w / (t["plain_ms"] / 1e3),
         mc_section_ms=section_ms, mc_section_walks_per_s=w / (section_ms / 1e3),
         successful=int(res_k.success.sum()), cpu_checked=cpu_check, **t)
    emit("resolve_events", graph=name, walks=w, max_steps=s, bitwise_equal_to_plain=True,
         **t_res)
    emit("greedy_scan", graph=name, walks=int(pg.start.shape[0]),
         mixed_walks=int(pm.start.shape[0]), max_steps=s, h=gd.h, bitwise_equal_to_plain=["greedy", "mixed"],
         from_the_plan=hi > lo, successful=int(g_res.success.sum()), **t_greedy)
    if not split:
        return
    # how far a step of the greedy scan is from one L2 hit, and a walk-step of
    # the resolution from the byte rate
    emit("greedy_scan_per_step", graph=name, chain_steps=t_greedy["chain_steps"],
         ms_per_step=t_greedy["ms"] / t_greedy["chain_steps"],
         ms_warm_per_step=t_greedy["ms_warm"] / t_greedy["chain_steps"],
         l2_load_ns=t_greedy["l2_load_ns"], hbm_load_ns=t_greedy["hbm_load_ns"],
         l2_hits_a_step=t_greedy["ms"] * 1e6 / t_greedy["chain_steps"] / t_greedy["l2_load_ns"])
    emit("resolve_events_per_walk_step", graph=name, walks=w, max_steps=s,
         ns_per_walk_step=t_res["ms"] * 1e6 / (w * s),
         bound_ns_per_walk_step=t_res["bound_ms"] * 1e6 / (w * s),
         share_of_bound=t_res["share_of_bound"])
    # the section part by part: the draw table in torch, as the section ran it
    # before the draw moved into the kernel
    draw = lambda: stable_bits_table(seed, pd.uid, s)
    parts = {k: dict(ms=cuda_ms(fn, 10), launches=device_launches(fn))
             for k, fn in (("draw_table", draw), ("fused_scan", scan), ("resolve", resolve),
                           ("greedy", lambda: engine.run_walks_kind(
                               gd, pg, seed, n_anchors=na, max_steps=s, kind="greedy")))}
    for k in ("fused_scan", "resolve", "greedy"):
        require(parts[k]["launches"] == 1, f"{name}: {k} launched {parts[k]['launches']} "
                                           "device kernels")
    emit("mc_split", graph=name, walks=w, max_steps=s, **{
        f"{k}_{m}": v for k, part in parts.items() for m, v in part.items()})
    section_launches = device_launches(section)
    require(section_launches == 2, f"{name}: the MC section launched {section_launches} "
                                   "device kernels, not the scan and the resolution")
    emit("mc_section", graph=name, walks=w, max_steps=s, ms=cuda_ms(section, 10),
         launches=section_launches, fused_scan_ms=parts["fused_scan"]["ms"],
         resolve_ms=parts["resolve"]["ms"], greedy_section_ms=parts["greedy"]["ms"],
         draw_table_ms_no_longer_run=parts["draw_table"]["ms"])


def _synthetic_plan(rng, n_nodes: int, w: int, uid):
    import numpy as np
    import torch

    from telomeri_tpu_torch.walk.engine import PlanDev

    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=DEVICE, dtype=dt)
    return PlanDev(start=put(rng.integers(0, n_nodes, w), torch.int32),
                   first_edge=put(np.full(w, -1), torch.int32), mode=put(np.full(w, 2), torch.int32),
                   uid=put(uid, torch.int32), active=put(rng.random(w) < 0.95, torch.bool))


def _check_scan_shapes(tandem_dir: str) -> None:
    """The three walk kernels against their plain versions where the main
    path's shapes do not reach: 48, 96, 512 and an odd number of steps on the
    tandem table, rescue uids (>= 1 << 30), a negative seed, wider rows (H =
    128, 256 and 512: hub rows, the last through the scan's looped path); the
    greedy scan on _greedy_plans of each case, greedy and mixed (H = 1024: the
    greedy scan's rows read in pages of 512 slots)."""
    import numpy as np
    import torch

    from telomeri_tpu_torch.kernels.walk_table import pack_wide, table_h
    from telomeri_tpu_torch.pipeline import ScaffoldConfig
    from telomeri_tpu_torch.walk.rescue import RESCUE_UID_BASE

    checked = []

    def check(name, wide, p, seed, s, n_anchors):
        _, _, res, _ = _scan_equals_plain(name, wide, p, seed, s, n_anchors)
        greedy = {}
        for kind, plan in zip(("greedy", "mixed"), _greedy_plans(p, table_h(wide))):
            _, g = _greedy_equals_plain(name, wide, plan, seed, s, n_anchors, kind)
            greedy[kind] = int(g.success.sum())
        checked.append(dict(case=name, h=table_h(wide), walks=int(p.start.shape[0]),
                            successful=int(res.success.sum()), greedy_successful=greedy))

    _, graph, plan = _build(tandem_dir, ScaffoldConfig(**_CORRECTED, max_steps=48))
    gd, pd = _mc_inputs(graph, plan, DEVICE)
    rescue_uid = pd._replace(uid=pd.uid + RESCUE_UID_BASE)
    for s, seed, p in ((48, 0, pd), (96, 0, pd), (512, 3, pd), (33, 0, pd), (1, 0, pd),
                       (48, 0, rescue_uid), (33, -7, rescue_uid), (32, -2**31, pd),
                       (33, 5, rescue_uid), (48, 1, pd), (33, -1, rescue_uid)):
        check(f"tandem S={s} seed={seed} uid0={int(p.uid[0])}", gd.wide, p, seed, s,
              graph.n_anchors)
    rng = np.random.default_rng(4)
    for h, k in ((128, 100), (128, 128), (256, 200), (512, 300), (1024, 600), (64, 64), (64, 40)):
        n, w = 4096, 20_000
        deg = rng.integers(0, k + 1, n)   # rows of 0..k edges, some dead (all-zero weights)
        slot = np.arange(k)[None, :] < deg[:, None]
        nbr = np.where(slot, rng.integers(0, n, (n, k)), -1)
        es = np.where(slot & (rng.random((n, k)) < 0.9), rng.uniform(0.5, 50, (n, k)), 0)
        cum = np.cumsum(np.ceil(es), axis=1).astype(np.int32)
        wide = torch.from_numpy(pack_wide(nbr, cum, np.where(slot, rng.integers(0, 10**6, (n, k)), -1),
                                          np.where(slot, 3, 0), es, es, h)).to(DEVICE)
        uid = np.concatenate([np.arange(w // 2), RESCUE_UID_BASE + np.arange(w - w // 2)])
        check(f"synthetic H={h} k={k}", wide, _synthetic_plan(rng, n, w, uid), -3, 33, 8)
    emit("walk_scan_shapes", ok=True, kernels=list(WALK_KERNELS), bitwise_equal=checked)


def _rescue_cap_plan(graph, plan):
    """The rescue round's batch cap: MAX_RESCUE_WALKS MC walks from contig ends."""
    import dataclasses

    import numpy as np

    from telomeri_tpu_torch.walk.rescue import MAX_RESCUE_WALKS, RESCUE_UID_BASE

    ends = np.flatnonzero(graph.anchor_mask() & (graph.deg > 0)).astype(np.int32)
    w = MAX_RESCUE_WALKS
    return dataclasses.replace(
        plan, start=np.resize(ends, w), first_edge=np.full(w, -1, np.int32),
        mode=np.full(w, 2, np.int32),
        uid=(RESCUE_UID_BASE + np.arange(w)).astype(np.int32),
        active=np.ones(w, bool), sections={"greedy": (0, 0), "mc": (0, w)})


def phase_walks(ecoli_dir: str, tandem_dir: str, results: dict) -> None:
    import numpy as np
    import torch

    from telomeri_tpu_torch.cli.main import main as cli
    from telomeri_tpu_torch.kernels import scoring
    from telomeri_tpu_torch.pipeline import ScaffoldConfig

    with open(os.path.join(LAMBDA, "config.json")) as f:
        lam_cfg = ScaffoldConfig.from_json(f.read())
    _, lam_graph, lam_plan = _build(LAMBDA, lam_cfg)
    _check_walk_scan("lambda", lam_graph, lam_plan, lam_cfg, results)

    require(cli(["simulate", "--out", tandem_dir, *SCENARIO_SIMS["tandem"]]) == 0,
            "simulate tandem failed")
    _check_scan_shapes(tandem_dir)

    t0 = time.perf_counter()
    require(cli(["simulate", "--preset", "ecoli", "--out", ecoli_dir]) == 0, "simulate failed")
    emit("simulate", preset="ecoli", seconds=round(time.perf_counter() - t0, 3))
    cfg = ScaffoldConfig(device_scoring="on")
    t0 = time.perf_counter()
    edges, graph, plan = _build(ecoli_dir, cfg)
    emit("ecoli_graph", seconds=round(time.perf_counter() - t0, 3), edges=len(edges),
         nodes=graph.n_nodes, k=graph.max_degree, walks=plan.n_active,
         sections=plan.sections)
    _check_walk_scan("ecoli", graph, plan, cfg, results, split=True)

    _check_walk_scan("ecoli_rescue_cap", graph, _rescue_cap_plan(graph, plan), cfg, results,
                     cpu_check=False)

    # the rescore kernel on the E. coli edges (the main path's shape and data)
    require(len(edges) == ECOLI_EDGES, f"E. coli has {len(edges)} edges, phase 2 timed "
                                       f"{ECOLI_EDGES} rows as the main path's shape")
    geom = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(DEVICE)
            for a in edges.geom_args()]
    got = scoring.score_overlaps_cuda(*geom, outputs=2)
    plain = scoring.score_overlaps_torch(*geom, outputs=2)
    err = max(max_abs_err(k, p) for k, p in zip(got, plain))
    for k, p, h in zip(got, plain, (edges.os_, edges.es)):
        require(same_bits(k, p) and same_bits(k, torch.from_numpy(h)),
                f"ecoli rescore: kernel differs (max abs err {err})")
    emit("ecoli_rescore", ok=True, rows=len(edges), max_abs_err=err,
         bitwise_equal_to=["plain", "build_edges' host scores"])
    del geom, got, plain
    _rescore_split(edges)


def _rescore_split(edges) -> None:
    """The rescore stage (io.geometry.rescore_edges_device) on the E. coli edges,
    part by part on the host's clock, each part ended by a synchronize: the
    upload as the package does it (eight pageable copies), with el, which
    rides as EL1 and EL2, sent once, and as one stacked (8, n) transfer; the
    kernel; the download; then the stage whole and the host's numpy scorer on
    the same rows."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from telomeri_tpu_torch.io import geometry
    from telomeri_tpu_torch.kernels import scoring

    def timed(fn, repeats: int = 7):
        """(median ms after one untimed call, the last result)."""
        ms = []
        for _ in range(repeats + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms[1:]), out

    host = [np.ascontiguousarray(a, dtype=np.int32) for a in edges.geom_args()]

    def el_once():
        dev = [torch.from_numpy(a).to(DEVICE) for a in host[:7]]
        return dev + [dev[6]]

    uploads = {"package": lambda: [torch.from_numpy(a).to(DEVICE) for a in host],
               "el_once": el_once,
               "stacked": lambda: list(torch.from_numpy(np.stack(host)).to(DEVICE))}
    require(host[6] is host[7] or np.array_equal(host[6], host[7]), "el1 and el2 differ")
    h2d_ms = {}
    for name, fn in uploads.items():
        h2d_ms[name], geom = timed(fn)
        got = scoring.score_overlaps_cuda(*geom, outputs=2)
        for k, h in zip(got, (edges.os_, edges.es)):
            require(same_bits(k, torch.from_numpy(h)), f"rescore upload {name}: scores differ")
    geom = uploads["package"]()
    kernel_ms, out = timed(lambda: scoring.score_overlaps_cuda(*geom, outputs=2))
    d2h_ms, _ = timed(lambda: [o.cpu().numpy() for o in out])
    whole_ms, rescored = timed(
        lambda: geometry.rescore_edges_device(dataclasses.replace(edges), DEVICE))
    require(same_bits(torch.from_numpy(rescored.os_), torch.from_numpy(edges.os_)) and
            same_bits(torch.from_numpy(rescored.es), torch.from_numpy(edges.es)),
            "rescore_edges_device changed the scores")
    host_ms, _ = timed(lambda: scoring.score_arrays_np(*host))
    emit("rescore_split", rows=len(edges), upload_mb=sum(a.nbytes for a in host) / 1e6,
         download_mb=2 * 4 * len(edges) / 1e6, h2d_ms=h2d_ms, kernel_ms=kernel_ms,
         d2h_ms=d2h_ms, whole_ms=whole_ms, host_numpy_ms=host_ms,
         clock="host perf_counter, each part ended by torch.cuda.synchronize; medians of 7")


def phase_lambda(tmp: str) -> None:
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts
    from telomeri_tpu_torch.pipeline import ScaffoldConfig, run_pipeline

    with open(os.path.join(LAMBDA, "config.json")) as f:
        cfg = json.load(f)
    cfg = ScaffoldConfig(**{**cfg, "device_scoring": "on"})
    out = os.path.join(tmp, "lambda.fa")
    reset_launch_counts()
    res = run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], out, cfg, device=DEVICE)
    counts = launch_counts()
    with open(out, "rb") as a, open(os.path.join(LAMBDA, "golden_scaffolds.fa"), "rb") as b:
        require(a.read() == b.read(), "lambda FASTA differs from golden_scaffolds.fa")
    for k in PATH_KERNELS:
        require(counts[k] > 0, f"lambda run never launched {k}")
    m = res.metrics.as_dict()
    emit("lambda", ok=True, golden_identical=True, launches=counts,
         scoring_backend=m["metrics"]["scoring_backend"],
         timings_s={k: round(v, 4) for k, v in m["timings_s"].items()})


def phase_ecoli(ecoli_dir: str) -> dict:
    from telomeri_tpu_torch.cli.main import main as cli
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts

    out = os.path.join(ecoli_dir, "scaffolds.fa")
    args = ["scaffold", "--device", DEVICE, "--device-scoring", "on", "--out", out]
    for flag, f in zip(("--contigs", "--reads", "--paf-read-contig", "--paf-read-read"),
                       INPUTS):
        args += [flag, os.path.join(ecoli_dir, f)]
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli(args)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    require(rc == 0, f"scaffold exited {rc}")
    for k in PATH_KERNELS:
        require(counts[k] > 0, f"E. coli run never launched {k}")
    with open(out + ".metrics.json") as f:
        m = json.load(f)
    timings, metrics = m["timings_s"], m["metrics"]
    dispatches = sorted(metrics.get("dispatches", {}))
    require(any(k.startswith("run_walks:") for k in dispatches) and
            any(k.startswith("score_edges:") for k in dispatches),
            f"E. coli metrics.json lacks the dispatch records: {dispatches}")
    with open(out) as f:
        n_scaffolds = sum(1 for ln in f if ln.startswith(">"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "telomeri_tpu_torch.cli.main", "validate",
         "--scaffolds", out, "--genome", os.path.join(ecoli_dir, "genome.fa"),
         "--stride", "64", "--index-cache", "off", "--jobs", str(os.cpu_count() or 1)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    require(proc.returncode == 0, f"validate failed: {proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout)
    emit("ecoli", wall_s=round(wall, 3), validate_s=round(time.perf_counter() - t0, 3),
         n_scaffolds=n_scaffolds, n_placed=rep["n_placed"],
         mean_identity=rep["mean_identity"], launches=counts,
         timings_s={k: round(v, 4) for k, v in timings.items()},
         n_walks=metrics["n_walks"], walk_stage_walks_per_s=metrics["n_walks"] / timings["run_walks"],
         dispatches={k: metrics["dispatches"][k]["s"] for k in dispatches},
         counters={k: metrics.get(k) for k in (
             "n_walks_successful", "n_bridges_candidate", "n_bridges_accepted",
             "n_bridges_rescued", "n_scaffolds", "parser_backend", "scoring_backend")})
    require(n_scaffolds == 1, f"E. coli gave {n_scaffolds} scaffolds, want 1")
    require(rep["n_placed"] == 1, f"n_placed {rep['n_placed']}, want 1")
    require(rep["mean_identity"] > 0.98, f"mean identity {rep['mean_identity']} <= 0.98")
    return counts


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _torchrun_scaffold(nproc: int, args: list[str], out: str, timeout: int = 600) -> dict:
    """`scaffold` under torchrun with nproc processes (its own process group,
    killed whole on a timeout); returns out's metrics.json."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "telomeri_tpu_torch.cli.main", "scaffold", *args, "--out", out]
    # its own dispatch history: two runs side by side would share the default file
    env = dict(os.environ, PYTHONPATH=ROOT, TELOMERI_CACHE=out + ".cache")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    require(proc.returncode == 0, f"torchrun {' '.join(args)} exited {proc.returncode}:\n"
                                  f"{err[-4000:]}")
    with open(out + ".metrics.json") as f:
        return json.load(f)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _mesh_library_runs(mesh, tmp: str, ecoli_dir: str) -> None:
    """run_pipeline on `mesh` (this process, warm) in both placements: lambda
    against golden_scaffolds.fa, then E. coli against phase 5's FASTA."""
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts
    from telomeri_tpu_torch.pipeline import ScaffoldConfig, run_pipeline

    with open(os.path.join(LAMBDA, "config.json")) as f:
        lam = json.load(f)
    for name, data, cfg, want in (
            ("lambda", LAMBDA, lam, os.path.join(LAMBDA, "golden_scaffolds.fa")),
            ("ecoli", ecoli_dir, {}, os.path.join(ecoli_dir, "scaffolds.fa"))):
        for placement in ("replicated", "rowshard"):
            c = ScaffoldConfig(**{**cfg, "device_scoring": "on", "graph_placement": placement})
            out = os.path.join(tmp, f"{name}_mesh_{placement}.fa")
            reset_launch_counts()
            res = run_pipeline(*[os.path.join(data, f) for f in INPUTS], out, c, mesh=mesh)
            counts = launch_counts()
            require(_read(out) == _read(want),
                    f"{name} on a mesh of 1 ({placement}) differs from {want}")
            # the row-sharded scans run their plain versions with the collective
            # fetch (dist/rowshard.py); the event resolution runs on the rank's card
            for k in ("walk_scan", "greedy_scan"):
                require((counts[k] > 0) == (placement == "replicated"),
                        f"{name} mesh {placement}: {k} launched {counts[k]} times")
            require(counts["resolve_events"] > 0, f"{name} mesh {placement}: no resolution launch")
            require(counts["score_os_es2"] > 0, f"{name} mesh {placement}: no rescore launch")
            emit("mesh_library", data=name, placement=placement, fasta_identical=True,
                 launches=counts, walk_stage_s=res.metrics.as_dict()["timings_s"]["run_walks"])


def _rowshard_fetch_cost(mesh, graph, plan) -> None:
    """One row-sharded walk step's fetch (all_gather + masked gather +
    reduce_scatter) against the replicated local gather, at the E. coli MC
    section's batch."""
    import torch

    from telomeri_tpu_torch.dist.rowshard import _collective_fetch, shard_graph_rows
    from telomeri_tpu_torch.kernels.walk_table import graph_to_device

    lo, hi = plan.sections["mc"]
    cur = torch.from_numpy(plan.start[lo:hi]).to(mesh.device)
    wide = graph_to_device(graph, mesh.device).wide
    fetch = _collective_fetch(shard_graph_rows(graph, mesh).wide, mesh)
    require(torch.equal(fetch(cur), wide[cur.long()]), "row-sharded fetch != local gather")
    ms, local_ms = paired_ms(lambda: fetch(cur), lambda: wide[cur.long()], 20)
    emit("rowshard_fetch", walks=hi - lo, row_bytes=int(wide.shape[1]) * 4, world=mesh.size,
         ms_per_step=ms, local_gather_ms_per_step=local_ms)


def phase_mesh(ecoli_dir: str, tmp: str) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from telomeri_tpu_torch.dist.mesh import init_distributed, make_walk_mesh, shutdown_distributed
    from telomeri_tpu_torch.pipeline import ScaffoldConfig

    want = _read(os.path.join(ecoli_dir, "scaffolds.fa"))   # phase 5's FASTA
    seqs = ["--contigs", os.path.join(ecoli_dir, INPUTS[0]),
            "--reads", os.path.join(ecoli_dir, INPUTS[1])]
    paf = ["--paf-read-contig", os.path.join(ecoli_dir, INPUTS[2]),
           "--paf-read-read", os.path.join(ecoli_dir, INPUTS[3])]
    base = ["--device", DEVICE, "--device-scoring", "on"]
    graph_a, walks_a = os.path.join(tmp, "mesh_graph.npz"), os.path.join(tmp, "mesh_walks.npz")

    def run(tag: str, nproc: int, placement: str, args: list[str]) -> None:
        out = os.path.join(tmp, f"mesh_{tag}.fa")
        t0 = time.perf_counter()
        m = _torchrun_scaffold(nproc, base + seqs + args + [
            "--mesh", str(nproc), "--graph-placement", placement], out)
        wall = time.perf_counter() - t0
        require(_read(out) == want, f"mesh run {tag}: FASTA differs from phase 5's")
        stage = "load_walks_artifact" if "--walks" in args else "run_walks"
        emit("mesh_run", run=tag, nproc=nproc, placement=placement, fasta_identical=True,
             walk_stage_s=m["timings_s"][stage], walk_stage=stage,
             torchrun_wall_s=round(wall, 3), n_walks=m["metrics"]["n_walks"],
             device=m["metrics"]["device"])

    def run_pair(*runs) -> None:
        """Two torchrun worlds of 1 side by side on the card: most of a run is
        its process reaching the card, which the next one need not wait for."""
        with ThreadPoolExecutor(max_workers=2) as pool:
            for done in [pool.submit(run, *r) for r in runs]:
                done.result()

    trace = os.path.join(tmp, "mesh_trace")
    run_pair(("replicated", 1, "replicated", paf),
             ("a_replicated_traced", 1, "replicated",
              paf + ["--save-graph", graph_a, "--save-walks", walks_a, "--trace", trace]))
    files = os.listdir(trace) if os.path.isdir(trace) else []
    require(len(files) == 1, f"--trace wrote {files}")
    text = _read(os.path.join(trace, files[0])).decode()
    kernels = [e["name"] for e in sorted(
        (e for e in json.loads(text)["traceEvents"] if e.get("cat") == "kernel"),
        key=lambda e: e["ts"])]
    # the walk stage is the three walk kernels in a row, as the reference's is
    # one program: no per-step stream of elementwise kernels between them
    at = {k: [i for i, name in enumerate(kernels) if f"{k}_kernel" in name] for k in WALK_KERNELS}
    require(all(at.values()), f"the replicated mesh trace lacks walk kernels: "
                              f"{ {k: len(v) for k, v in at.items()} }")
    window = kernels[min(at["greedy_scan"]):max(at["resolve_events"]) + 1]
    require(len(window) <= 2 * len(WALK_KERNELS),
            f"the walk stage ran {len(window)} device kernels: {window[:12]}")
    emit("mesh_trace", file=files[0], bytes=len(text), device_kernels=len(kernels),
         walk_stage_kernels=len(window), walk_stage=window,
         launches={k: len(v) for k, v in at.items()})
    run_pair(("b_rowshard", 1, "rowshard", paf),
             ("c_resume", 1, "replicated", ["--graph", graph_a, "--walks", walks_a]))

    _, graph, plan = _build(ecoli_dir, ScaffoldConfig(device_scoring="on"))
    init_distributed(DEVICE)   # a world of 1 in this process
    try:
        mesh = make_walk_mesh(1, DEVICE)
        _mesh_library_runs(mesh, tmp, ecoli_dir)
        _rowshard_fetch_cost(mesh, graph, plan)
    finally:
        shutdown_distributed()
    n_dev = torch.cuda.device_count()
    worlds = [n for n in (2, 4) if n <= n_dev]
    for n in worlds:
        run(f"replicated_x{n}", n, "replicated", paf)
        run(f"rowshard_x{n}", n, "rowshard", paf)
    emit("mesh", ok=True, devices=n_dev, multi_device_worlds=worlds)


def _scenario_run(data: str, cfg, out_dir: str, device: str):
    """run_pipeline on `device`, leaving out_dir as `scaffold --save-graph
    --save-walks` leaves a run directory; (result, FASTA bytes, wall s)."""
    from telomeri_tpu_torch.pipeline import run_pipeline

    os.makedirs(out_dir)
    out = os.path.join(out_dir, "out.fa")
    t0 = time.perf_counter()
    res = run_pipeline(*[os.path.join(data, f) for f in INPUTS], out, cfg, device=device,
                       save_graph_path=os.path.join(out_dir, "graph.npz"),
                       save_walks_path=os.path.join(out_dir, "walks.npz"))
    wall = time.perf_counter() - t0
    with open(out + ".config.json", "w") as f:
        f.write(cfg.to_json())
    return res, _read(out), wall


def _gap_report(rundir: str) -> str:
    """The tool's report of a run directory, its consensus replayed on the card."""
    proc = subprocess.run([sys.executable, "-m", "telomeri_tpu_torch.gap_report",
                           "--device", DEVICE, rundir],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    require(proc.returncode == 0, f"gap_report {rundir} exited {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    return proc.stdout


def _metrics_besides_device(res) -> tuple[dict, list[str]]:
    """(the run's metrics without the device, the scoring backend and the
    dispatch records, the dispatch keys)."""
    m = dict(res.metrics.as_dict()["metrics"])
    for k in ("device", "scoring_backend"):
        m.pop(k, None)
    return m, sorted(m.pop("dispatches", {}))


def _device_stage_s(res) -> dict:
    """The run's device stages (and polish, the host stage that dominates), s."""
    return {k: round(v, 4) for k, v in res.metrics.as_dict()["timings_s"].items()
            if k in ("score_edges_device", "run_walks", "consensus", "rescue_round_0",
                     "polish")}


def phase_scenarios(tmp: str, tandem_dir: str) -> None:
    import numpy as np
    import torch

    from telomeri_tpu_torch.cli.main import main as cli
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts
    from telomeri_tpu_torch.pipeline import ScaffoldConfig

    t0 = time.perf_counter()
    data = {"tandem": tandem_dir, "rescue": os.path.join(tmp, "sim_rescue")}   # tandem: phase 3's
    require(cli(["simulate", "--out", data["rescue"], *SCENARIO_SIMS["rescue"]]) == 0,
            "simulate rescue failed")
    scan_launches = {}
    for name, dataset, kw, pairs in SCENARIOS:
        cfg = ScaffoldConfig(**kw, device_scoring="on")
        reset_launch_counts()
        card, card_fa, card_s = _scenario_run(data[dataset], cfg,
                                              os.path.join(tmp, f"{name}_card"), DEVICE)
        counts = launch_counts()
        cpu, cpu_fa, cpu_s = _scenario_run(data[dataset], cfg, os.path.join(tmp, f"{name}_cpu"),
                                           "cpu")
        require(card_fa == cpu_fa, f"{name}: FASTA differs between {DEVICE} and cpu")
        for f, a, b in zip(card.walks._fields, card.walks, cpu.walks):
            require(same_bits(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))),
                    f"{name}: walk records differ between {DEVICE} and cpu in {f}")
        require([(b.pair, b.rep_uid) for b in card.accepted] ==
                [(b.pair, b.rep_uid) for b in cpu.accepted],
                f"{name}: accepted bridges or representatives differ")
        (m_card, d_card), (m_cpu, d_cpu) = map(_metrics_besides_device, (card, cpu))
        require(m_card == m_cpu and d_card == d_cpu, f"{name}: metrics differ")
        got = {b.pair for b in card.accepted}
        require(got == pairs, f"{name}: accepted {sorted(got)}, want {sorted(pairs)}")
        # the tandem runs bridge every gap, so their rescue round never starts
        # and each of their walk-scan launches is the walk stage's
        rescued = "rescue_walks:R0" in d_card
        require(rescued == (name == "rescue_r1"), f"{name}: rescue round ran: {rescued}")
        require(all(counts[k] > 0 for k in PATH_KERNELS), f"{name}: kernel launches {counts}")
        steps = card.walks.steps
        require(cfg.max_steps <= 32 or bool((steps > 32).any()),
                f"{name}: no walk ran past 32 steps")
        scan_launches[name] = counts["walk_scan"]
        emit("scenario", name=name, max_steps=cfg.max_steps, rescue_rounds=cfg.rescue_rounds,
             rescue_round_ran=rescued, walks=int(len(steps)),
             walks_past_32_steps=int((steps > 32).sum()), pairs=sorted(got),
             n_bridges_rescued=m_card.get("n_bridges_rescued"),
             fasta_identical=True, records_identical=True, dispatches=d_card,
             launches=counts, wall_s={DEVICE: round(card_s, 4), "cpu": round(cpu_s, 4)},
             timings_s={DEVICE: _device_stage_s(card), "cpu": _device_stage_s(cpu)})
    require(scan_launches["rescue_r1"] > scan_launches["rescue_r0"],
            f"the rescue round launched no walk scan: {scan_launches}")
    # the card's artifacts through `python -m`, the CPU's through the library
    # call in this process (a second process would spend its time reaching the card)
    from telomeri_tpu_torch.gap_report import diagnose

    buf = io.StringIO()
    diagnose(os.path.join(tmp, "rescue_r0_cpu"), out=buf, device=DEVICE)
    reports = [_gap_report(os.path.join(tmp, "rescue_r0_card")), buf.getvalue()]
    require(reports[0] == reports[1], "gap_report differs between the card's and the CPU's run")
    missed = json.loads(reports[0])["missed"]
    require([d["gap"] for d in missed] == [2], f"gap_report missed {missed}")
    emit("scenarios", ok=True, gap_report_identical=True, gap_report_missed=missed,
         walk_scan_launches=scan_launches, seconds=round(time.perf_counter() - t0, 3))


BENCH_CELLS = (("small", 4096), ("peak", 131072))   # MC walks per contig end
PEAK_ABOVE = 2**20      # the widest batch the scan was held to its plain version before
ORACLE_BUDGET_S = 6.0   # the bench's own default is 18 s
BENCH_SCORING_ROWS = 64_000_000   # the bench's own default


def _bench_walk_rows(results: dict, part: str, launches: dict, wide, pd, seed, s, n_anchors,
                     iters: int, greedy_pd=None):
    """The walk kernels at one bench part's shape and inputs: the scan's records
    and the walks resolved from them bit-equal to the plain versions', every
    walk, and the greedy scan on the part's greedy section (greedy_pd), then
    each one's kernel_times; the kernels-line rows "<kernel>@bench_<part>" with
    that part's own launch counts. Returns (max abs err, the resolved walks)."""
    import torch

    from telomeri_tpu_torch.kernels import greedy_scan, walk_events, walk_scan
    from telomeri_tpu_torch.kernels.walk_table import pick_plane, table_h

    w, h = int(pd.start.shape[0]), table_h(wide)
    kern, err, res, res_err = _scan_equals_plain(f"bench {part}", wide, pd, seed, s, n_anchors)
    row = dict(path=f"bench {part}")
    picks = pick_plane(wide)   # once per table, as GraphDev builds it
    t = kernel_times(lambda: walk_scan.walk_scan_cuda(wide, pd.start, pd.uid, seed, s,
                                                      picks=picks),
                     lambda: _plain_scan(wide, pd.start, pd.uid, seed, s),
                     _scan_bound(kern, wide, pd, s), iters)
    results[f"walk_scan@bench_{part}"] = dict(max_abs_err=err, launches=launches["walk_scan"],
                                              **row, **t)
    emit("walk_scan", graph=f"bench_{part}", walks=w, max_steps=s, h=h,
         nodes=int(wide.shape[0]), walks_checked=w, bitwise_equal_to_plain=True,
         walks_per_s=w / (t["ms"] / 1e3), **t)
    torch.cuda.empty_cache()
    t = kernel_times(lambda: walk_events.resolve_events_cuda(
        pd.start, pd.active, *kern, n_anchors=n_anchors, max_steps=s),
        lambda: walk_events.resolve_events_torch(pd.start, pd.active, *kern,
                                                 n_nodes=int(wide.shape[0]),
                                                 n_anchors=n_anchors, max_steps=s),
        _resolve_bound(res, pd, s), iters)
    results[f"resolve_events@bench_{part}"] = dict(
        max_abs_err=res_err, launches=launches["resolve_events"], **row, **t)
    emit("resolve_events", graph=f"bench_{part}", walks=w, max_steps=s, walks_checked=w,
         bitwise_equal_to_plain=True, **t)
    del kern
    torch.cuda.empty_cache()
    if greedy_pd is not None:
        g_err, g_res = _greedy_equals_plain(f"bench {part}", wide, greedy_pd, seed, s,
                                            n_anchors, "greedy")
        t = kernel_times(lambda: greedy_scan.greedy_scan_cuda(wide, greedy_pd, seed, n_anchors,
                                                              s, "greedy"),
                         lambda: greedy_scan.greedy_scan_torch(wide, greedy_pd, seed, n_anchors,
                                                               s, "greedy"),
                         _greedy_bound(g_res, greedy_pd, h, s), iters)
        results[f"greedy_scan@bench_{part}"] = dict(
            max_abs_err=g_err, launches=launches["greedy_scan"], **row, **t)
        emit("greedy_scan", graph=f"bench_{part}", walks=int(greedy_pd.start.shape[0]),
             max_steps=s, h=h, walks_checked=int(greedy_pd.start.shape[0]),
             bitwise_equal_to_plain=True, successful=int(g_res.success.sum()), **t)
    return err, res


def phase_bench(results: dict) -> None:
    """The bench's parts through telomeri_tpu_torch.bench, each with its own
    kernel launch count (zeroed before the part, read after it; comparisons
    with the plain versions not counted), and each part's kernel held to its
    plain version at the shape and on the inputs the part gave it."""
    import torch

    from telomeri_tpu_torch import bench
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts, scoring
    from telomeri_tpu_torch.kernels.walk_table import device_table_bytes

    t_phase = time.perf_counter()
    label = bench.device_label(torch.device(DEVICE))
    counts: dict = {}

    def counted(part: str, kernels: tuple, fn):
        reset_launch_counts()
        out = fn()
        counts[part] = launch_counts()
        require(all(counts[part][k] > 0 for k in kernels),
                f"bench {part} never launched one of {kernels}: {counts[part]}")
        return out

    cfg, _, graph, plan = bench.build_problem(BENCH_CELLS[0][1], device_scoring="off",
                                              device=DEVICE)
    oracle = bench.bench_oracle(cfg, graph, plan, budget_s=ORACLE_BUDGET_S)
    emit("bench_oracle", walks_per_s=oracle[0], steps_per_s=oracle[1],
         budget_s=ORACLE_BUDGET_S, budget_cut_from_s=18.0, rows=len(bench.oracle_rows(plan)))
    cells = {}
    for cell, mc in BENCH_CELLS:
        if cell == "peak":
            cfg, edges, graph, plan = bench.build_problem(mc, device=DEVICE)
        walks_per_s, steps_per_s, split = counted(
            cell, WALK_KERNELS, lambda: bench.bench_walks(cfg, graph, plan, 5, DEVICE))
        require(split["greedy_launches"] == 1 and split["resolve_launches"] == 1,
                f"bench {cell}: the greedy section or the resolution is not one launch: {split}")
        line = bench.emit(walks_per_s, steps_per_s, oracle, plan.n_active, label)
        cells[cell] = line["value"]
        emit("bench", cell=cell, mc_walks_per_end=mc,
             table_mb=device_table_bytes(graph) / 1e6,
             sections=plan.sections, split_ms=split, launches=counts[cell], **line)
        # the cell's sections, as bench_walks ran them: every walk against the
        # plain versions
        gd, pd = _mc_inputs(graph, plan, DEVICE)
        require(cell != "peak" or pd.start.shape[0] > PEAK_ABOVE,
                f"the peak MC section has {pd.start.shape[0]} walks, no more than {PEAK_ABOVE}")
        _bench_walk_rows(results, cell, counts[cell], gd.wide, pd, cfg.mc_seed, cfg.max_steps,
                         graph.n_anchors, 5 if cell == "small" else 3,
                         greedy_pd=_section(plan, "greedy", DEVICE))
        del gd, pd
        torch.cuda.empty_cache()
    require(cells["peak"] > cells["small"], f"the peak batch is no faster than the small: {cells}")

    # the scoring bench on its own tiled geometry, then the kernel there against
    # its plain version
    geom = bench.tiled_geometry(edges, BENCH_SCORING_ROWS, DEVICE)
    sc = counted("scoring", ("score_os_es2",), lambda: bench.bench_scoring(edges, 5, DEVICE, geom=geom))
    require(sc["rows"] == int(geom[0].shape[0]), f"bench_scoring scored {sc['rows']} rows")
    got = scoring.score_overlaps_cuda(*geom, outputs=2)
    plain = scoring.score_overlaps_torch(*geom, outputs=2)
    torch.cuda.synchronize()
    err = max(max_abs_err(k, p) for k, p in zip(got, plain))
    for c, k, p in zip(("os", "es2"), got, plain):
        require(same_bits(k, p), f"bench scoring, {sc['rows']} rows, {c}: kernel != plain "
                                 f"(max abs err {err})")
    del got, plain
    t = kernel_times(lambda: scoring.score_overlaps_cuda(*geom, outputs=2),
                     lambda: scoring.score_overlaps_torch(*geom, outputs=2),
                     _scoring_bound(sc["rows"], 2), 5)
    results["score_os_es2@bench_scoring"] = dict(
        max_abs_err=err, launches=counts["scoring"]["score_os_es2"], path="bench scoring", **t)
    emit("bench_scoring", rows=sc["rows"], burst_ms=sc["ms"], overlaps_per_s=sc["overlaps_per_s"],
         host_numpy_overlaps_per_s=sc["host_overlaps_per_s"], bitwise_equal_to_plain=True,
         burst_timing="one pair of CUDA events around a burst of 10 wrapper calls (warm)",
         launches=counts["scoring"], device=label, **t)
    del geom
    torch.cuda.empty_cache()

    # the whole-human-scale table, at the largest N the host's memory allows
    n = bench.HG002_N
    free = bench.host_memory_available()
    while free is not None and n > 2**16 and free < bench.hg002_host_bytes(n):
        n //= 2
    gd, pd = bench.hg002_problem(DEVICE, n)
    line = counted("hg002", ("walk_scan", "resolve_events"),
                   lambda: bench.hg002_walks(gd, pd, DEVICE))
    words = int(gd.wide.shape[0]) * int(gd.wide.shape[1])
    err, res = _bench_walk_rows(results, "hg002", counts["hg002"], gd.wide, pd, 1,
                                bench.SYNTH_STEPS, bench.SYNTH_ANCHORS, 5)
    emit("bench_hg002", full_size=n == bench.HG002_N, table_words=words,
         offsets_past_int32=words > 2**31, host_memory_available_gib=None if free is None
         else free / 2**30, bitwise_equal_to_plain=True, max_abs_err=err,
         successful=int(res.success.sum()), launches=counts["hg002"], **line)
    del gd, pd, res
    torch.cuda.empty_cache()
    emit("bench_done", launches=counts, seconds=round(time.perf_counter() - t_phase, 3))


def phase_chunked(ecoli_dir: str) -> None:
    """Does the chunked path keep the bound on device memory that max_walk_batch
    exists for, through the consensus too?"""
    import dataclasses

    import torch

    from telomeri_tpu_torch.pipeline import ScaffoldConfig, _consensus
    from telomeri_tpu_torch.kernels.walk_table import device_table_bytes
    from telomeri_tpu_torch.walk.engine import run_walks_host

    base_cfg = ScaffoldConfig(device_scoring="on")
    _, graph, plan = _build(ecoli_dir, base_cfg)
    out = {}
    for name, batch in (("unchunked", base_cfg.max_walk_batch), ("chunked", 8192)):
        cfg = dataclasses.replace(base_cfg, max_walk_batch=batch)
        require((batch < len(plan)) == (name == "chunked"), f"{name}: plan of {len(plan)} rows")
        row = dict(max_walk_batch=batch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for stage in ("run_walks", "consensus"):
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if stage == "run_walks":
                walks = run_walks_host(graph, plan, cfg, DEVICE)
            else:
                cons = _consensus(walks, plan, graph, cfg, DEVICE)
            torch.cuda.synchronize()
            row[stage] = dict(seconds=round(time.perf_counter() - t0, 4),
                              held_before_mb=held / 1e6,
                              peak_mb=torch.cuda.max_memory_allocated() / 1e6)
        row["records_mb"] = sum(a.numel() * a.element_size() for a in walks) / 1e6
        row["records_on"] = str(walks.nodes.device)
        out[name] = (row, walks.to_numpy(), cons)   # off the card before the next run
        del walks
    (_, w0, c0), (_, w1, c1) = out["unchunked"], out["chunked"]
    for f, a, b in zip(w0._fields, w0, w1):
        require(same_bits(torch.from_numpy(a), torch.from_numpy(b)),
                f"chunked walks differ from unchunked in {f}")
    for f, a, b in zip(c0._fields, c0, c1):
        require((a is None and b is None) or same_bits(torch.from_numpy(a), torch.from_numpy(b)),
                f"chunked consensus differs from unchunked in {f}")
    emit("chunked", plan_rows=len(plan), table_mb=device_table_bytes(graph) / 1e6,
         records_identical=True, consensus_identical=True,
         **{k: v[0] for k, v in out.items()})


def _run_module(module: str, args: list[str], timeout: int = 600, env: dict | None = None):
    """`python -m module args` from the checkout, in its own process group
    (killed whole on a timeout); (stdout, stderr)."""
    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    require(proc.returncode == 0, f"python -m {module} {' '.join(args)} exited "
                                  f"{proc.returncode}:\n{err[-4000:]}")
    return out, err


def phase_dryrun() -> None:
    import torch

    worlds = [n for n in (1, 2) if n <= torch.cuda.device_count()]
    for n in worlds:
        t0 = time.perf_counter()
        out, _ = _run_module("telomeri_tpu_torch.dryrun", ["--device", DEVICE, "--mesh", str(n)])
        summary = json.loads(out.strip().splitlines()[-1])["dryrun"]
        require(summary["devices"] == n and summary["successful"] > 0 and
                summary["fasta_bytes"] > 0, f"dry run at a world of {n}: {summary}")
        for k in PATH_KERNELS:   # rank 0's launches: its shard's MC block, its rescoring
            require(summary["launches"][k] > 0, f"dry run at a world of {n} never launched {k}")
        emit("dryrun", seconds=round(time.perf_counter() - t0, 3), **summary)
    emit("dryrun_done", ok=True, worlds=worlds,
         not_run=None if 2 in worlds else "a world of 2 needs two cards; this machine has one")


def _walks_by_uid(path: str) -> dict:
    """A walks artifact's active rows in uid order."""
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        keep = np.flatnonzero(z["plan_active"])
        order = keep[np.argsort(z["plan_uid"][keep], kind="stable")]
        return {f: z[f][order] for f in z.files if f != "header"}


def phase_multi_card(ecoli_dir: str, tmp: str) -> None:
    """`scaffold --mesh 2` with no launcher and --save-walks on two cards."""
    import numpy as np
    import torch

    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        emit("multi_card", ran=False, devices=n_dev,
             why="the self-launched --mesh 2 and --save-walks on a mesh need two cards; the "
                 "CPU tests run both on gloo worlds of 2")
        return
    out, walks = os.path.join(tmp, "self_mesh2.fa"), os.path.join(tmp, "self_mesh2_walks.npz")
    args = ["scaffold", "--device", DEVICE, "--device-scoring", "on", "--mesh", "2",
            "--out", out, "--save-walks", walks]
    for flag, f in zip(("--contigs", "--reads", "--paf-read-contig", "--paf-read-read"), INPUTS):
        args += [flag, os.path.join(ecoli_dir, f)]
    launcher = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")
    require(not any(k in os.environ for k in launcher), "chip_smoke itself runs under a launcher")
    t0 = time.perf_counter()
    _, err = _run_module("telomeri_tpu_torch.cli.main", args,
                         env=dict(TELOMERI_CACHE=out + ".cache"))
    require("--save-walks skipped" not in err, "--save-walks was skipped on a one-host mesh")
    require(_read(out) == _read(os.path.join(ecoli_dir, "scaffolds.fa")),
            "self-launched --mesh 2: FASTA differs from phase 5's")
    one, got = _walks_by_uid(os.path.join(tmp, "mesh_walks.npz")), _walks_by_uid(walks)
    require(sorted(one) == sorted(got), "walks artifacts hold different arrays")
    for f in one:
        a, b = one[f], got[f]
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        require(a.shape == b.shape and bool((a == b).all()),
                f"--save-walks on a mesh of 2: {f} differs from the one-device artifact")
    with open(out + ".metrics.json") as f:
        m = json.load(f)
    emit("multi_card", ran=True, devices=n_dev, launcher="none: the CLI started its 2 ranks",
         fasta_identical=True, saved_walks_identical=True, walks=int(len(got["plan_uid"])),
         walk_stage_s=m["timings_s"]["run_walks"], wall_s=round(time.perf_counter() - t0, 3))


def phase_native(ecoli_dir: str) -> None:
    """The port's C++ parsers on this host: built with g++, then the E. coli
    run again in a fresh process, against phase 5's run with the Python parsers."""
    t0 = time.perf_counter()
    _run_module("telomeri_tpu_torch.native.build", [], timeout=300)
    build_s = time.perf_counter() - t0
    with open(os.path.join(ecoli_dir, "scaffolds.fa.metrics.json")) as f:
        py = json.load(f)
    require(py["metrics"]["parser_backend"] == "python",
            f"phase 5 ran with the {py['metrics']['parser_backend']} parsers")
    out = os.path.join(ecoli_dir, "native.fa")
    args = ["scaffold", "--device", DEVICE, "--device-scoring", "on", "--out", out]
    for flag, f in zip(("--contigs", "--reads", "--paf-read-contig", "--paf-read-read"), INPUTS):
        args += [flag, os.path.join(ecoli_dir, f)]
    t0 = time.perf_counter()
    _run_module("telomeri_tpu_torch.cli.main", args, env=dict(TELOMERI_CACHE=out + ".cache"))
    wall = time.perf_counter() - t0
    with open(out + ".metrics.json") as f:
        nat = json.load(f)
    require(nat["metrics"]["parser_backend"] == "native",
            f"after the build the run used the {nat['metrics']['parser_backend']} parsers")
    require(_read(out) == _read(os.path.join(ecoli_dir, "scaffolds.fa")),
            "the native parsers' FASTA differs from the Python parsers'")
    stages = ("parse_paf", "load_sequences")
    emit("native", ok=True, build_s=round(build_s, 3), fasta_identical=True,
         python_s={k: py["timings_s"][k] for k in stages},
         native_s={k: nat["timings_s"][k] for k in stages},
         native_process_wall_s=round(wall, 3),
         note="python: phase 5's run in this warm process; native: a fresh process")


def _host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host time of fn() in microseconds: `calls` calls on the host's clock over
    the calls, the median of `repeats` loops; the card is synchronised after
    each loop, outside the time (a launch is timed to its return, not its run)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    us = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(us)


def wrapper_split(kernel: str, wrapper, launch_args: list, tensors: list, check, w: int,
                  s: int) -> dict:
    """Where one wrapper call's host time goes, piece by piece (_host_us each):
    its input checks, the .contiguous() calls, the torch.cuda.device context,
    seven torch.empty outputs, the current stream, the data_ptr() calls, the
    ctypes call alone (arguments made beforehand: the launch), and the whole
    wrapper; beside them what the pieces could be instead (the seven outputs
    by new_empty, the current device read, the stream of the device asked
    for)."""
    import torch

    from telomeri_tpu_torch.kernels import build

    lib = build.load()
    dev = tensors[0].device
    fn = getattr(lib, f"telomeri_{kernel}")
    i32 = dict(dtype=torch.int32, device=dev)

    def empties():
        return (torch.empty((w, s + 1), **i32), torch.empty((w, s), **i32), torch.empty(w, **i32),
                torch.empty(w, dtype=torch.bool, device=dev), torch.empty(w, **i32),
                torch.empty(w, **i32), torch.empty(w, dtype=torch.float32, device=dev))

    like = tensors[-2]   # an int32 input on the device (uid, start)

    def new_empties():
        return (like.new_empty((w, s + 1)), like.new_empty((w, s)), like.new_empty(w),
                like.new_empty(w, dtype=torch.bool), like.new_empty(w), like.new_empty(w),
                like.new_empty(w, dtype=torch.float32))

    def context():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "checks": check,
        "contiguous": lambda: [t.contiguous() for t in tensors],
        "device_context": context,
        "empty_x7": empties,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "data_ptrs": lambda: [t.data_ptr() for t in tensors] + [t.data_ptr() for t in empties()],
        "launch": lambda: fn(*launch_args),
        "wrapper": wrapper,
        "alt_new_empty_x7": new_empties,
        "alt_current_device": lambda: torch.cuda.current_device() == dev.index,
        "alt_stream_of_device": lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    out = {k: _host_us(f) for k, f in pieces.items()}
    out["data_ptrs"] -= out["empty_x7"]   # its outputs' allocation is not the data_ptr calls'
    return out


def walk_kernel_times(data_dir: str) -> dict:
    """The greedy scan and the event resolution at every shape PERF.md keeps
    for them, each held bitwise to its plain version there and timed by
    kernel_times: E. coli (its greedy section and its MC section, simulated
    into data_dir unless it holds the preset already) and the rescue round's
    cap on its table, the bench's small and peak cells (greedy section, MC
    section) and the whole-human-scale table (MC section; the walk scan is
    timed too, as phases 3 and 8 do); then each wrapper's host time split at
    E. coli. One JSON line of every reading (`walk_kernels`)."""
    import torch

    from telomeri_tpu_torch import bench
    from telomeri_tpu_torch.cli.main import main as cli
    from telomeri_tpu_torch.kernels import build, greedy_scan, walk_events, walk_scan
    from telomeri_tpu_torch.pipeline import ScaffoldConfig

    results: dict = {}
    if not os.path.exists(os.path.join(data_dir, "genome.fa")):
        require(cli(["simulate", "--preset", "ecoli", "--out", data_dir]) == 0, "simulate failed")
    cfg = ScaffoldConfig(device_scoring="on")
    _, graph, plan = _build(data_dir, cfg)
    _check_walk_scan("ecoli", graph, plan, cfg, results, cpu_check=False, split=True)
    _check_walk_scan("ecoli_rescue_cap", graph, _rescue_cap_plan(graph, plan), cfg, results,
                     cpu_check=False)
    # each wrapper's host time, piece by piece, at E. coli
    gd, pd = _mc_inputs(graph, plan, DEVICE)
    pg = _section(plan, "greedy", DEVICE)
    s, seed, na = cfg.max_steps, cfg.mc_seed, graph.n_anchors
    recs = walk_scan.walk_scan_cuda(gd.wide, pd.start, pd.uid, seed, s)
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    wg, wm = int(pg.start.shape[0]), int(pd.start.shape[0])
    g_out = greedy_scan.greedy_scan_cuda(gd.wide, pg, seed, na, s, "greedy")
    r_out = walk_events.resolve_events_cuda(pd.start, pd.active, *recs, n_anchors=na, max_steps=s)
    g_in = [gd.wide, *[getattr(pg, f) for f in ("start", "first_edge", "mode", "uid", "active")]]
    r_in = [*recs, pd.start, pd.active]
    split = {
        "greedy_scan": wrapper_split(
            "greedy_scan", lambda: greedy_scan.greedy_scan_cuda(gd.wide, pg, seed, na, s, "greedy"),
            [gd.wide.data_ptr(), gd.h, int(gd.wide.shape[0]), *[t.data_ptr() for t in g_in[1:]],
             seed & 0xFFFFFFFF, 2 * na, 0, wg, s, *[t.data_ptr() for t in g_out], stream],
            g_in, lambda: greedy_scan._check(gd.wide, pg, "greedy"), wg, s),
        "resolve_events": wrapper_split(
            "resolve_events", lambda: walk_events.resolve_events_cuda(
                pd.start, pd.active, *recs, n_anchors=na, max_steps=s),
            [*[t.data_ptr() for t in r_in], 2 * na, wm, s, *[t.data_ptr() for t in r_out], stream],
            r_in, lambda: walk_events._check(pd.start, pd.active, recs, s), wm, s),
    }
    emit("wrapper_host_split", walks={"greedy_scan": wg, "resolve_events": wm}, max_steps=s,
         us=split, timing="host clock, 200 calls a loop, median of 5 loops, the card "
                          "synchronised between loops")
    del gd, pd, pg, recs, g_out, r_out
    torch.cuda.empty_cache()

    zero = {k: 0 for k in ("walk_scan", "greedy_scan", "resolve_events")}
    for cell, mc in BENCH_CELLS:
        cfg_b, _, graph_b, plan_b = bench.build_problem(mc, device_scoring="off", device=DEVICE)
        gd, pd = _mc_inputs(graph_b, plan_b, DEVICE)
        _bench_walk_rows(results, cell, zero, gd.wide, pd, cfg_b.mc_seed, cfg_b.max_steps,
                         graph_b.n_anchors, 5 if cell == "small" else 3,
                         greedy_pd=_section(plan_b, "greedy", DEVICE))
        del gd, pd
        torch.cuda.empty_cache()
    n = bench.HG002_N
    free = bench.host_memory_available()
    while free is not None and n > 2**16 and free < bench.hg002_host_bytes(n):
        n //= 2
    gd, pd = bench.hg002_problem(DEVICE, n)
    _bench_walk_rows(results, "hg002", zero, gd.wide, pd, 1, bench.SYNTH_STEPS,
                     bench.SYNTH_ANCHORS, 5)
    del gd, pd
    torch.cuda.empty_cache()
    keep = ("ms", "ms_warm", "wrapper_host_us", "plain_ms", "bound_ms", "share_of_bound",
            "all_planes_bound_ms", "chain_ms", "chain_steps", "l2_load_ns", "max_abs_err")
    return {key: {k: v for k, v in r.items() if k in keep} for key, r in results.items()}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import telomeri_tpu_torch  # noqa: F401  (fails outside a checkout)

    if argv[:1] == ["walk-kernels"] and len(argv) == 2:
        # the walk kernels' readings alone (see walk_kernel_times): no contract line
        phase_device()
        phase_build()
        print(json.dumps({"walk_kernels": walk_kernel_times(argv[1])}), flush=True)
        return 0
    if argv:
        print(f"chip_smoke: takes no arguments (or `walk-kernels DATA_DIR`), got {argv}",
              file=sys.stderr)
        return 2
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # a native parser library left by an earlier run: phases 3-7 run with the
    # Python parsers, as a fresh checkout does, and phase 12 builds it anew
    native = os.path.join(ROOT, "build", "telomeri_tpu_torch", "libtelomeri_native.so")
    if os.path.exists(native):
        os.remove(native)
    ecoli_dir, tandem_dir = os.path.join(work, "ecoli"), os.path.join(work, "sim_tandem")
    results: dict = {}
    try:
        phase_device()
        phase_build()
        phase_scoring(results)
        phase_walks(ecoli_dir, tandem_dir, results)
        phase_lambda(work)
        counts = phase_ecoli(ecoli_dir)
        phase_mesh(ecoli_dir, work)
        phase_scenarios(work, tandem_dir)
        phase_bench(results)
        phase_chunked(ecoli_dir)
        phase_dryrun()
        phase_multi_card(ecoli_dir, work)
        phase_native(ecoli_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    loaded = sorted(m for m in ("telomeri_tpu", "jax") if m in sys.modules)
    require(not loaded, f"the port's run imported {loaded}")

    kernels = []
    # each kernel at the scaffold path's (E. coli) shape, from phases 2 and 3,
    # with that run's launch count; then the bench's parts from phase 8, each
    # at its own shape with its own part's count
    shapes = [(name, f"{name}@ecoli" if name in WALK_KERNELS else f"{name}@{ECOLI_EDGES}")
              for name in SOURCES]
    shapes += [(key.split("@")[0], key) for key in results if "@bench_" in key]
    for name, key in shapes:
        src, replaces = SOURCES[name]
        t = results[key]
        # ms: device time with the L2 flushed; library_ms: no single PyTorch call
        # computes any of these functions
        kernels.append(dict(name=name, shape=key.split("@")[1], route="cuda", source=src,
                            replaces=replaces, path=t.get("path", "scaffold E. coli"),
                            launches=t.get("launches", counts[name]),
                            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                            ms_warm=t["ms_warm"], wrapper_host_us=t["wrapper_host_us"],
                            **{k: t[k] for k in ("chain_ms", "chain_steps") if k in t}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

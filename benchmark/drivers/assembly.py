"""Whole assemblies, one at a time, as a user runs `scaffold` (a closed loop).

Set-up simulates the configuration's dataset from the seed (kept under
benchmark/.inputs/<config>-<seed>/, so only a seed's first run in a checkout
pays for it; the time is reported as `inputs_s` and left out of setup_s, since
it stands in for files a user already has), builds the program's kernels and
native parsers once per checkout, and runs one untimed assembly. The window runs
telomeri_tpu_torch.pipeline.run_pipeline on the same files, each assembly
writing its scaffolds FASTA under TMPDIR, until --seconds have passed; the last
one runs to its end. assembly_s is the window's wall time over its assemblies.
A traced run adds one assembly under torch.profiler after the window, with a
span around every pipeline stage (the Metrics.stage calls) to name the idle
gaps.

Every assembly's FASTA is judged against the simulated genome
(reference/assembly.py) after the window, once per distinct output.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import cells
from ..reference import assembly as ref
from ..trace import profile_slice, span

INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
INPUT_DIR = os.path.join(cells.BENCH_DIR, ".inputs")
STAMP = os.path.join(cells.BENCH_DIR, ".cache", "native.sha256")


@dataclass
class State:
    cell: cells.Cell
    device: torch.device
    data: str
    cfg: object
    entry: object
    metrics_cls: type
    out_dir: str
    limits: dict
    inputs_s: float = 0.0
    outputs: list[str] = field(default_factory=list)


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def make_inputs(cell: cells.Cell, seed: int) -> str:
    """The seed's dataset directory, simulated unless a complete one is there:
    the four inputs, genome.fa and truth.npz (each contig's genome interval)."""
    from ..gen import sim

    params = dict(cell.config["sim"], seed=seed % 2**64)
    with open(sim.__file__, "rb") as f:
        stamp = _digest(f.read(), json.dumps(params, sort_keys=True).encode())
    path = os.path.join(INPUT_DIR, f"{cell.config_name}-{seed}")
    try:
        with open(os.path.join(path, "stamp")) as f:
            if f.read() == stamp:
                return path
    except OSError:
        pass
    tmp = f"{path}.part"
    shutil.rmtree(tmp, ignore_errors=True)
    d = sim.simulate(sim.SimConfig(**params))
    sim.write_dataset(d, tmp)
    np.savez(os.path.join(tmp, "truth.npz"), contig_pos=np.asarray(d.contig_pos, np.int64))
    with open(os.path.join(tmp, "stamp"), "w") as f:
        f.write(stamp)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def build_native() -> None:
    """The program's native parsers, built once per checkout and again only
    when their sources change."""
    from telomeri_tpu_torch.native import build as nb

    srcs = b"".join(open(os.path.join(nb.HERE, s), "rb").read() for s in nb.SOURCES)
    want = _digest(srcs)
    try:
        with open(STAMP) as f:
            if f.read() == want and os.path.exists(nb.OUT):
                return
    except OSError:
        pass
    nb.build(verbose=False)
    os.makedirs(os.path.dirname(STAMP), exist_ok=True)
    with open(STAMP, "w") as f:
        f.write(want)


def span_metrics_class():
    """The program's Metrics with a trace span around every stage."""
    from telomeri_tpu_torch.utils.logging import Metrics

    class SpanMetrics(Metrics):
        @contextmanager
        def stage(self, name: str):
            with span(name), Metrics.stage(self, name):
                yield

    return SpanMetrics


def setup(cell: cells.Cell, seed: int, device, trace: bool) -> State:
    from telomeri_tpu_torch.config import ScaffoldConfig
    from telomeri_tpu_torch.pipeline import run_pipeline

    device = torch.device(device)
    t0 = time.perf_counter()
    data = make_inputs(cell, seed)
    t1 = time.perf_counter()
    if device.type == "cuda":
        from telomeri_tpu_torch.kernels import build as kb

        kb.load()
        build_native()
    t2 = time.perf_counter()
    state = State(cell=cell, device=device, data=data,
                  cfg=ScaffoldConfig(**cell.config.get("scaffold", {})), entry=run_pipeline,
                  metrics_cls=span_metrics_class(),
                  out_dir=tempfile.mkdtemp(prefix="bench-assembly-"),
                  limits=cells.limits(cell), inputs_s=t1 - t0)
    _assemble(state, os.path.join(state.out_dir, "warm-up.fa"))
    print(f"set-up: inputs {t1 - t0:.2f} s, kernels and parsers {t2 - t1:.2f} s, "
          f"warm-up assembly {time.perf_counter() - t2:.2f} s", file=sys.stderr, flush=True)
    return state


def _assemble(state: State, out: str):
    metrics = state.metrics_cls()
    with span("assembly"):
        state.entry(*[os.path.join(state.data, f) for f in INPUTS], out, state.cfg, metrics,
                    device=state.device)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
    return metrics


def measure(state: State, seconds: float, trace: bool) -> dict:
    os.makedirs(state.out_dir, exist_ok=True)
    timings = []
    t0 = time.perf_counter()
    while True:
        out = os.path.join(state.out_dir, f"asm-{len(state.outputs)}.fa")
        t, cpu = time.perf_counter(), os.times()
        timings.append(dict(_assemble(state, out).timings))
        state.outputs.append(out)
        top = sorted(timings[-1].items(), key=lambda kv: -kv[1])[:6]
        now = os.times()
        print(f"assembly {len(timings)}: {time.perf_counter() - t:.3f} s, user "
              f"{now.user - cpu.user:.2f} s, system {now.system - cpu.system:.2f} s; "
              + ", ".join(f"{k} {v:.3f}" for k, v in top), file=sys.stderr, flush=True)
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    observed: dict = {"stage_timings": timings}
    if trace:
        out = os.path.join(state.out_dir, "traced.fa")
        observed["profile"] = profile_slice(lambda: _assemble(state, out), state.device)
        state.outputs.append(out)
    return dict(end_to_end={"assembly_s": wall / len(timings)},
                attempted=len(state.outputs), observed=observed)


def release(state: State) -> None:
    """The program keeps no device state between assemblies."""


def judge(state: State) -> tuple[dict, int]:
    """Each distinct FASTA of the window against the genome; the worst reading
    of each number, and the assemblies that broke a limit. The files judged
    are deleted."""
    genome, pos = ref.load_truth(os.path.join(state.data, "genome.fa"),
                                 os.path.join(state.data, "truth.npz"))
    seen: dict[str, dict] = {}
    worst = {k: 0 for k in state.limits}
    failed = 0
    for path in state.outputs:
        with open(path, "rb") as f:
            key = _digest(f.read())
        if key not in seen:
            seen[key] = ref.judge(ref.read_fasta(path), genome, pos)
        got = seen[key]
        failed += any(got[k] > lim for k, lim in state.limits.items())
        worst = {k: max(worst[k], got[k]) for k in worst}
    shutil.rmtree(state.out_dir, ignore_errors=True)
    state.outputs = []
    return {k: {"value": worst[k], "limit": lim} for k, lim in state.limits.items()}, failed


# --- faults: the timed path broken underneath (tests and benchmark/control.py) --------

def _edit_output(state: State, edit) -> None:
    inner = state.entry

    def entry(*args, **kw):
        res = inner(*args, **kw)
        edit(args[4])
        return res

    state.entry = entry


def _rewrite(path: str, records: list[tuple[str, bytes]]) -> None:
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            for off in range(0, len(seq), 80):
                f.write(seq[off:off + 80] + b"\n")


def _at_contig0(state: State, change) -> None:
    """Edit the scaffold that holds contig 0's interior, turned so that the
    contig reads forward: change(seq, end, genome, pos) gets the scaffold, the
    position just past the interior, the genome and the contigs' intervals,
    and returns the new scaffold."""
    genome, pos = ref.load_truth(os.path.join(state.data, "genome.fa"),
                                 os.path.join(state.data, "truth.npz"))
    (lo, hi), = ref.interiors([pos[0]])
    probe = genome[lo:hi]

    def edit(path):
        recs = ref.read_fasta(path)
        for i, (name, seq) in enumerate(recs):
            for flip in (False, True):
                fwd = ref.revcomp(seq) if flip else seq
                p = fwd.find(probe)
                if p >= 0:
                    fwd = change(fwd, p + len(probe), genome, pos)
                    recs[i] = (name, ref.revcomp(fwd) if flip else fwd)
                    _rewrite(path, recs)
                    return
    _edit_output(state, edit)


def _random_bases(n: int) -> bytes:
    return np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(12345).integers(0, 4, n)].tobytes()


def control(state: State) -> None:
    """A misjoin: the longest scaffold's second half turned to the other strand."""
    def edit(path):
        recs = ref.read_fasta(path)
        i = max(range(len(recs)), key=lambda j: len(recs[j][1]))
        name, seq = recs[i]
        half = len(seq) // 2
        recs[i] = (name, seq[:half] + ref.revcomp(seq[half:]))
        _rewrite(path, recs)
    _edit_output(state, edit)


def state_unchanged(state: State) -> None:
    """The assembly hands back its input: every contig a scaffold of its own."""
    _edit_output(state, lambda path: shutil.copyfile(
        os.path.join(state.data, "contigs.fa"), path))


def half_left_out(state: State) -> None:
    """Half of every scaffold left out."""
    _edit_output(state, lambda path: _rewrite(
        path, [(n, s[:len(s) // 2]) for n, s in ref.read_fasta(path)]))


def answer_altered(state: State) -> None:
    """One base in the middle of contig 0's interior changed where the
    stitcher wrote it."""
    def change(seq, end, genome, pos):
        (lo, hi), = ref.interiors([pos[0]])
        q = end - (hi - lo) // 2
        return seq[:q] + (b"A" if seq[q:q + 1] != b"A" else b"C") + seq[q + 1:]
    _at_contig0(state, change)


def fill_altered(state: State) -> None:
    """500 bases taken out 10 kb past contig 0's interior, in its trimmed end
    or the fill."""
    _at_contig0(state, lambda seq, end, genome, pos: seq[:end + 10_000] + seq[end + 10_500:])


def fill_random(state: State) -> None:
    """The repeat copy after contig 0, where it lies in a scaffold without
    indels, replaced by random bases of its length."""
    def change(seq, end, genome, pos):
        q = end + pos[0][1] - ref.interiors([pos[0]])[0][1]
        n = pos[1][0] - pos[0][1]
        return seq[:q] + _random_bases(n) + seq[q + n:]
    _at_contig0(state, change)


def end_altered(state: State) -> None:
    """The first 1,000 bases of the scaffold that begins with contig 0
    replaced by random bases."""
    _at_contig0(state, lambda seq, end, genome, pos: _random_bases(1_000) + seq[1_000:])


def scaffold_added(state: State) -> None:
    """A scaffold of 20,000 random bases added to the output."""
    def edit(path):
        _rewrite(path, ref.read_fasta(path) + [("extra", _random_bases(20_000))])
    _edit_output(state, edit)


FAULTS = dict(control=control, state_unchanged=state_unchanged, half_left_out=half_left_out,
              answer_altered=answer_altered, fill_altered=fill_altered, fill_random=fill_random,
              end_altered=end_altered, scaffold_added=scaffold_added)

"""Back-to-back Monte-Carlo walk dispatches on a device-resident table.

Set-up makes the configuration's table and the mix's plan on the device from
the seed (gen/walk_table.py), hands them to the program as its packed table
and an all-MC plan section, builds the program's kernels once per checkout,
and runs the calls the window will hold results of, untimed. The window calls
telomeri_tpu_torch.walk.engine.run_walks_prepared back to back, call i with
mc_seed (seed + i) mod 2**31, the records left on the device, until --seconds
have passed on the host, then synchronizes: walks_per_s is all walks of the
window over its wall time. A traced run profiles `trace_calls` more calls
after the window.

The results of calls 0, the last, two drawn from the seed among the first
`sample_range`, and the traced ones are kept and, after the window, held
field by field to the plain reference (reference/walks.py) on the same table
and plan; the traced calls' byte counts for the kernels' rooflines come from
the same reference pass.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import cells, roofline
from ..gen import walk_table
from ..reference import walks as ref
from ..trace import profile_slice, span


@dataclass
class State:
    cell: cells.Cell
    device: torch.device
    table: torch.Tensor
    plan: dict
    gd: object
    sections: list
    base: int
    sample: set
    limits: dict
    entry: object
    kept: dict = field(default_factory=dict)     # call index -> WalkResult
    traced: list = field(default_factory=list)   # indices of the profiled calls
    observed: dict = field(default_factory=dict)

    def seed_of(self, i: int) -> int:
        return (self.base + i) % 2**31

    def call(self, i: int):
        c = self.cell.config
        return self.entry(self.gd, self.sections, self.seed_of(i), n_anchors=c["n_anchors"],
                          max_steps=c["max_steps"])


def setup(cell: cells.Cell, seed: int, device, trace: bool) -> State:
    from telomeri_tpu_torch.walk.engine import GraphDev, PlanDev, run_walks_prepared

    device = torch.device(device)
    c, p = cell.config, cell.mix["params"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    table = walk_table.make_table(c["n_nodes"], c["max_degree"], n_anchors=c["n_anchors"],
                                  deg=tuple(c["degree"]), es=tuple(c["es"]),
                                  adv=tuple(c["adv"]), gen=gen, device=device)
    plan = walk_table.make_plan(p["walks_per_call"], n_anchors=c["n_anchors"], gen=gen,
                                device=device)
    rng = np.random.default_rng(seed % 2**64)
    sample = {0, *(int(i) for i in rng.choice(np.arange(1, p["sample_range"]),
                                              p["sampled_calls"], replace=False))}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    if device.type == "cuda":
        from telomeri_tpu_torch.kernels import build as kb

        kb.load()
    t2 = time.perf_counter()
    state = State(cell=cell, device=device, table=table, plan=plan,
                  gd=GraphDev(wide=table), sections=[("mc", PlanDev(**plan))],
                  base=seed % 2**31, sample=sample, limits=cells.limits(cell),
                  entry=run_walks_prepared)
    # as many results held at once as the window holds, so its allocations come
    # from the allocator's pool
    held = [state.call(-1 - j) for j in range(len(sample) + 2)]
    del held
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"set-up: table and plan {t1 - t0:.2f} s, kernels {t2 - t1:.2f} s, "
          f"warm-up calls {time.perf_counter() - t2:.2f} s", file=sys.stderr, flush=True)
    return state


def measure(state: State, seconds: float, trace: bool) -> dict:
    n_walks = int(state.plan["start"].shape[0])
    i = 0
    t0 = time.perf_counter()
    while True:   # at least one call
        last = state.call(i)
        if i in state.sample:
            state.kept[i] = last
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    wall = time.perf_counter() - t0
    state.kept[i - 1] = last
    attempted = i
    if trace:
        n = state.cell.mix["params"]["trace_calls"]
        state.traced = list(range(i, i + n))

        def run():
            for j in state.traced:
                with span("run_walks_prepared"):
                    state.kept[j] = state.call(j)

        prof = profile_slice(run, state.device)
        if prof["busy_s"] is None:
            prof = event_times(state)
        state.observed["profile"] = prof
        attempted += n
    return dict(end_to_end={"walks_per_s": i * n_walks / wall}, attempted=attempted,
                observed=state.observed)


def event_times(state: State) -> dict:
    """Where the profiler recorded no device time: the scan and the resolution
    of the traced calls, each timed by CUDA events around the same calls
    through the program's wrappers (at 2M walks a kernel far outlasts its
    wrapper's host time)."""
    from telomeri_tpu_torch.kernels.walk_scan import walk_scan
    from telomeri_tpu_torch.walk.engine import resolve_mc_events

    c = state.cell.config
    pd = state.sections[0][1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    scan_ms = resolve_ms = 0.0
    t0 = time.perf_counter()
    for j in state.traced:
        ev[0].record()
        recs = walk_scan(state.table, pd.start, pd.uid, state.seed_of(j), c["max_steps"])
        ev[1].record()
        resolve_mc_events(pd, *recs, n_nodes=c["n_nodes"], n_anchors=c["n_anchors"],
                          max_steps=c["max_steps"])
        ev[2].record()
        torch.cuda.synchronize(state.device)
        scan_ms += ev[0].elapsed_time(ev[1])
        resolve_ms += ev[1].elapsed_time(ev[2])
    wall = time.perf_counter() - t0
    kernel_s = {"walk_scan_kernel": scan_ms / 1e3, "resolve_events_kernel": resolve_ms / 1e3}
    return dict(busy_s=(scan_ms + resolve_ms) / 1e3, window_s=wall, kernel_s=kernel_s,
                device_ops=[[k, v] for k, v in kernel_s.items()], idle_gaps=[],
                source="cuda_events")


def release(state: State) -> None:
    """The program holds nothing but the kept results, which the judgement reads."""


def judge(state: State) -> tuple[dict, int]:
    """Every kept call against the reference, field by field; for the traced
    calls also the bytes and operations their kernels needed."""
    c = state.cell.config
    s, h = c["max_steps"], state.table.shape[1] // 6
    pl = state.plan
    w = int(pl["start"].shape[0])
    differing = failed = 0
    need = {"scan": [0, 0], "resolve": [0, 0], "calls": 0}
    for i in sorted(state.kept):
        got = state.kept.pop(i)
        counter = roofline.ScanCounter(c["n_nodes"], state.device) if i in state.traced else None
        bad_call = 0
        for lo, hi, fields, rec, rows in ref.walk_blocks(
                state.table, pl["start"], pl["uid"], pl["active"], state.seed_of(i),
                n_anchors=c["n_anchors"], steps=s):
            bad_call += int(ref.differing(tuple(a[lo:hi] for a in got), fields).sum())
            if counter is not None:
                counter.add(rows, rec[2])
                b, o = roofline.resolve_need(hi - lo, s, fields[2], fields[3], pl["active"][lo:hi])
                need["resolve"][0] += b
                need["resolve"][1] += o
        if counter is not None:
            n_rows, n_picks = counter.counts()
            print(f"call {i}: {n_rows} distinct rows, {n_picks} distinct picks",
                  file=sys.stderr, flush=True)
            b, o = roofline.scan_need(w, s, h, n_rows, n_picks)
            need["scan"][0] += b
            need["scan"][1] += o
            need["calls"] += 1
        differing += bad_call
        failed += bad_call > 0
        del got
    if need["calls"]:
        state.observed["need"] = need
    return {"walks_differing": {"value": differing, "limit": state.limits["walks_differing"]}}, failed


# --- faults: the timed path broken underneath (tests and benchmark/control.py) --------

def control(state: State) -> None:
    """The reference in the program's place, its step sum in bfloat16."""
    from telomeri_tpu_torch.walk.engine import WalkResult

    def entry(gd, sections, seed, *, n_anchors, max_steps):
        pd = sections[0][1]
        parts = [f for _, _, f, _, _ in ref.walk_blocks(
            gd.wide, pd.start, pd.uid, pd.active, seed, n_anchors=n_anchors, steps=max_steps,
            score_dtype=torch.bfloat16)]
        return WalkResult(*[torch.cat(a) for a in zip(*parts)])

    state.entry = entry


def state_unchanged(state: State) -> None:
    """Every call hands back the result of the call before the window."""
    stale = state.call(-1)
    state.entry = lambda *args, **kw: stale


def half_left_out(state: State) -> None:
    """Only the first half of the walks run; their results stand for the rest."""
    from telomeri_tpu_torch.walk.engine import PlanDev, WalkResult

    inner = state.entry

    def entry(gd, sections, seed, **kw):
        pd = sections[0][1]
        half = pd.start.shape[0] // 2
        res = inner(gd, [("mc", PlanDev(*[a[:half] for a in pd]))], seed, **kw)
        rest = pd.start.shape[0] - half
        return WalkResult(*[torch.cat([a, a[:rest]]) for a in res])

    state.entry = entry


def answer_altered(state: State) -> None:
    """One node of one walk changed where the program wrote it."""
    inner = state.entry

    def entry(*args, **kw):
        res = inner(*args, **kw)
        nodes = res.nodes.clone()
        nodes[nodes.shape[0] // 2, 1] += 1
        return res._replace(nodes=nodes)

    state.entry = entry


FAULTS = dict(control=control, state_unchanged=state_unchanged, half_left_out=half_left_out,
              answer_altered=answer_altered)

"""Batched greedy + Monte-Carlo walk engine in torch: the port of telomeri_tpu/walk/engine.py.

Semantics are the reference's, bit for bit (its module docstring is normative):
walks start at oriented anchor nodes; greedy walks (mode 0 by OS, mode 1 by ES)
reroute around their history; MC walks (mode 2) sample slot j with probability
w_j / total over the full row by integer inverse-CDF against the static row
cumsum, and die on a revisit (cycle kill); a walk succeeds on stepping onto
another anchor node (id < 2 * n_anchors).

Device layout: GraphDev.wide is the reference's packed (N, 6H) int32 table
[nbr | cum | eid | adv | es_bits | os_bits]. On a card the MC scan also reads
GraphDev.picks, the (N, H, 4) int32 pick plane derived from it (slot j's nbr,
eid, adv and es_bits side by side: one 16-byte sector a step instead of four
sectors in four blocks), built once per table on the first CUDA MC scan; CPU
tables and the row-sharded placement never build it. The walk stage on one
device is one launch per part, as the reference's is one program
(_run_walks_multi): the MC section runs the historyless scan (kernels/walk_scan.py), then
resolve_mc_events finds each walk's first event from the per-step records
(kernels/walk_events.py); greedy and mixed sections run _kind_core, the scan
with the in-scan visited table (kernels/greedy_scan.py). Each part is a
hand-written CUDA kernel on CUDA tensors and its plain torch version on CPU
tensors; the row-sharded placement (dist/rowshard.py) runs the plain scans with
its collective row fetch on any device.

RNG: step s of walk `uid` draws lane s % 2 of Threefry-2x32 block s // 2 on the
key fold_in(key(seed), uid), exactly as jax.random does. On a card the MC and
mixed sections' kernels compute the draw in registers (csrc/walk_common.cuh);
stable_bits_table is the same stream as a (S, W) table in torch, for CPU
tensors, the row-sharded scans and the oracle. Its uint32 arithmetic runs on
int64 tensors masked to 32 bits; torch.Generator is not used, because it does
not produce this stream.

Dtypes follow the reference with JAX x64 off: node ids, uids, records and
sentinels are int32, score_sum is float32. score_sum is summed over steps in
float32 in the order XLA's CPU backend (jax 0.9.0) uses for the reference's
(W, S) row reduce, on every device, so the sums are bit-equal to it (the
consensus rule 5 tie-break compares them exactly). That order is XLA's tree
reduction rewrite with a window of 32: up to 32 steps, one sequential sum from
0.0; above 32, the steps are padded with zeros to a multiple of 32, pad // 2
zeros in front and the rest behind, each window of 32 is summed sequentially
from 0.0, and the window sums are reduced by the same rule
(kernels/walk_common.py sum_steps, here _sum_steps; the walk kernels' StepSum). So
S = 48 sums steps [0, 24) and [24, 48) and adds the two; S = 96 sums three
windows of 32 left to right.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.walk.plan import WalkPlan
from telomeri_tpu_torch.kernels.greedy_scan import greedy_scan, greedy_scan_torch
from telomeri_tpu_torch.kernels.walk_common import (  # noqa: F401  (the order above)
    sum_steps as _sum_steps,
)
from telomeri_tpu_torch.kernels.walk_events import resolve_events
from telomeri_tpu_torch.kernels.walk_scan import pick_plane, walk_scan
from telomeri_tpu_torch.utils.profiling import count, count_copy, profiler_running, span

_M32 = 0xFFFFFFFF


class GraphDev:
    """Device-resident packed walk table (see the reference's GraphDev).

    wide: (N, 6H) int32, column blocks [nbr | cum | eid | adv | es_bits | os_bits].
    picks: the MC kernel's pick plane, (N, H, 4) int32 (kernels/walk_scan.py
    pick_plane), derived from `wide` on its first read and kept for the
    table's life. So `wide` is read-only (a new table is a new GraphDev) and
    is not to be edited in place after construction: the plane would no
    longer match it."""

    __slots__ = ("_wide", "_picks")

    def __init__(self, wide: torch.Tensor):
        self._wide = wide
        self._picks: torch.Tensor | None = None

    @property
    def wide(self) -> torch.Tensor:
        return self._wide

    @property
    def h(self) -> int:
        return self.wide.shape[1] // 6

    @property
    def picks(self) -> torch.Tensor:
        if self._picks is None:
            self._picks = pick_plane(self.wide)
        return self._picks


class PlanDev(NamedTuple):
    start: torch.Tensor       # (W,) int32
    first_edge: torch.Tensor  # (W,) int32
    mode: torch.Tensor        # (W,) int32
    uid: torch.Tensor         # (W,) int32
    active: torch.Tensor      # (W,) bool


class WalkResult(NamedTuple):
    """Fixed-shape walk records (the reference's WalkResult, as tensors)."""

    nodes: torch.Tensor      # (W, S+1) int32, -1 pad; [:, 0] is the start anchor
    eids: torch.Tensor       # (W, S) int32 edge ids taken, -1 pad
    steps: torch.Tensor      # (W,) int32 edges taken
    success: torch.Tensor    # (W,) bool reached another anchor
    terminal: torch.Tensor   # (W,) int32 terminal anchor node or -1
    path_len: torch.Tensor   # (W,) int32 sum of edge advances (bp)
    score_sum: torch.Tensor  # (W,) float32 sum of edge ES

    def to_numpy(self) -> "WalkResult":
        """The same records as host numpy arrays (host records pass through)."""
        dev = self.nodes.device if isinstance(self.nodes, torch.Tensor) else "cpu"
        with span("walk.download", W=len(self.steps)):
            out = WalkResult(*[a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                               for a in self])
        count_copy(out, dev, "cpu")
        return out

    def to(self, device) -> "WalkResult":
        return WalkResult(*[torch.as_tensor(a).to(device) for a in self])


# --- Threefry-2x32 draw table --------------------------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, as jax.random's threefry_2x32: key (k0, k1),
    counters (x0, x1). uint32 values in int64 tensors (or ints) that broadcast;
    every sum is masked back to 32 bits, so nothing overflows int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def stable_bits_table(seed: int, uid: torch.Tensor, max_steps: int) -> torch.Tensor:
    """(S, W) int32 table of per-step MC draw bits (uint32 bit patterns).

    The port of the reference's _stable_bits_table: key(seed) is (0, seed) as in
    jax.random with x64 off (the seed is an int32), fold_in(key, uid) hashes the
    counter pair (0, uid), and block b hashes the FIXED counters (2b, 2b+1), so
    step s = lane s % 2 of block s // 2 and the stream is a stable prefix in
    max_steps."""
    n_blocks = (max_steps + 1) // 2
    dev = uid.device
    k0, k1 = threefry2x32(0, int(seed) & _M32, 0, uid.to(torch.int64) & _M32)
    b = torch.arange(n_blocks, dtype=torch.int64, device=dev)[None, :]
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], 2 * b, 2 * b + 1)   # (W, B)
    bits = torch.stack([y0, y1], dim=2).reshape(uid.shape[0], 2 * n_blocks)
    bits = bits[:, :max_steps].T                                        # (S, W)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).contiguous()


# --- host-side table packing (numpy copies of the reference's helpers) ---------

def mc_weights(es: np.ndarray) -> np.ndarray:
    """Integer MC sampling weights: ceil(ES) for ES > 0 (at least 1), else 0."""
    es = np.asarray(es, np.float32)
    return np.where(es > 0, np.maximum(np.ceil(es), 1), 0).astype(np.int32)


def _cum_arrays(g: GraphTensors) -> np.ndarray:
    if g.cumw is not None:
        return g.cumw
    return np.cumsum(mc_weights(g.es), axis=1, dtype=np.int64).astype(np.int32)


def lane_width(k: int) -> int:
    """Padded CSR half-width H: the smallest of 64, 128, 256, ... >= k."""
    h = 64
    while h < k:
        h *= 2
    return h


def _pad_cols(a: np.ndarray, h: int, fill) -> np.ndarray:
    if a.shape[1] == h:
        return a
    pad = np.broadcast_to(fill, (a.shape[0], h - a.shape[1])).astype(a.dtype)
    return np.concatenate([a, pad], axis=1)


def pack_wide(nbr, cumw, eid, adv, es, os_, h: int) -> np.ndarray:
    """Pack the (N, K) CSR tables into the (N, 6H) wide row. cum pads carry the
    row total, so the compare-count never lands on them."""
    cum_pad = _pad_cols(cumw, h, 0)
    if h != cumw.shape[1]:
        cum_pad = cum_pad.copy()
        cum_pad[:, cumw.shape[1]:] = cumw[:, -1:] if cumw.shape[1] else 0
    return np.concatenate([
        _pad_cols(nbr, h, -1).astype(np.int32),
        cum_pad.astype(np.int32),
        _pad_cols(eid, h, -1).astype(np.int32),
        _pad_cols(adv, h, 0).astype(np.int32),
        _pad_cols(es, h, 0.0).astype(np.float32).view(np.int32),
        _pad_cols(os_, h, 0.0).astype(np.float32).view(np.int32),
    ], axis=1)


def device_table_bytes(g: GraphTensors) -> int:
    """Device footprint of the packed walk table (N * 6H int32)."""
    return g.nbr.shape[0] * 6 * lane_width(g.nbr.shape[1]) * 4


def device_walk_bytes(g: GraphTensors, device) -> int:
    """Device footprint of the walk stage's tables on `device`: the packed
    table, and on a card also the MC kernel's pick plane (N * H * 4 int32,
    2/3 of the table), which GraphDev.picks builds beside it."""
    need = device_table_bytes(g)
    if torch.device(device).type == "cuda":
        need += need * 4 // 6
    return need


def graph_to_device(g: GraphTensors, device) -> GraphDev:
    h = lane_width(g.nbr.shape[1])
    with span("walk.pack", N=g.nbr.shape[0], H=h):
        wide = pack_wide(g.nbr, _cum_arrays(g), g.eid, g.adv, g.es, g.os_, h)
    with span("walk.upload", N=g.nbr.shape[0], H=h):
        gd = GraphDev(wide=torch.from_numpy(wide).to(device))
    count_copy([gd.wide], "cpu", device)
    return gd


def plan_to_device(p: WalkPlan, device) -> PlanDev:
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)
    with span("plan.upload", W=len(p.start)):
        pd = PlanDev(start=put(p.start, torch.int32),
                     first_edge=put(p.first_edge, torch.int32),
                     mode=put(p.mode, torch.int32), uid=put(p.uid, torch.int32),
                     active=put(p.active, torch.bool))
    count_copy(pd, "cpu", device)
    return pd


# --- scans ---------------------------------------------------------------------

def run_walks_mc(gd: GraphDev, p: PlanDev, seed, *, n_anchors: int,
                 max_steps: int) -> WalkResult:
    """All-MC section (the reference's _run_walks_mc_fast / _mc_fast_core): the
    historyless scan (on a card over the table's pick plane, built on the
    first call), then post-hoc event resolution."""
    picks = gd.picks if gd.wide.is_cuda else None
    nxt, tot, eid, adv, es = walk_scan(gd.wide, p.start, p.uid, seed, max_steps, picks)
    return resolve_mc_events(p, nxt, tot, eid, adv, es,
                             n_nodes=int(gd.wide.shape[0]), n_anchors=n_anchors,
                             max_steps=max_steps)


def resolve_mc_events(p: PlanDev, nxts, totals, eids_new, adv_new, es_bits_new, *,
                      n_nodes: int, n_anchors: int, max_steps: int) -> WalkResult:
    """Post-hoc MC event resolution over (W, S) int32 per-step records: the
    first of dead row, revisit (cycle kill) or anchor hit ends the walk; a kill
    at the same step as an anchor hit wins (kernels/walk_events.py: the kernel
    on CUDA tensors, the plain version with both revisit branches of the
    reference on CPU tensors). n_nodes is the GLOBAL row count, which picks the
    plain version's revisit branch."""
    return WalkResult(*resolve_events(p.start, p.active, nxts, totals, eids_new, adv_new,
                                      es_bits_new, n_nodes=n_nodes, n_anchors=n_anchors,
                                      max_steps=max_steps))


def _kind_core(gd: GraphDev, p: PlanDev, seed, *, n_anchors: int, max_steps: int,
               kind: str, fetch=None) -> WalkResult:
    """Mixed / greedy scan with the in-scan visited table (the reference's
    _kind_core). With the default local fetch: the kernel on a CUDA table, the
    plain loop on a CPU one (kernels/greedy_scan.py). fetch(cur) -> (W, 6H)
    rows is dist/rowshard.py's collective fetch: then the plain loop runs on
    every device, a collective a step, as the reference's row-sharded mode runs
    its own scan; that is the one place the plain version runs on a card."""
    if fetch is None:
        out = greedy_scan(gd.wide, p, seed, n_anchors, max_steps, kind)
    else:
        out = greedy_scan_torch(gd.wide, p, seed, n_anchors, max_steps, kind, fetch=fetch)
    return WalkResult(*out)


def count_dispatch(sections: list[tuple[str, PlanDev]], max_steps: int) -> tuple[int, int]:
    """Count one walk dispatch over `sections` in walk.dispatches, walk.walks
    and walk.steps_scanned (every section scans max_steps steps); returns the
    dispatch's number and its walks, the ids of its span walk.dispatch."""
    w = 0
    for _, pd in sections:
        w += pd.start.shape[0]
    count("walk.walks", w)
    count("walk.steps_scanned", w * max_steps)
    return count("walk.dispatches"), w


def run_walks_kind(gd: GraphDev, p: PlanDev, seed, *, n_anchors: int,
                   max_steps: int, kind: str) -> WalkResult:
    """One scan specialised by section kind: "mc" (all-MC, first_edge == -1),
    "greedy" (no RNG) or "mixed" (any modes); the span walk.section."""
    if not profiler_running():
        return _run_kind(gd, p, seed, n_anchors, max_steps, kind)
    with span("walk.section", kind=kind):
        return _run_kind(gd, p, seed, n_anchors, max_steps, kind)


def _run_kind(gd: GraphDev, p: PlanDev, seed, n_anchors: int, max_steps: int,
              kind: str) -> WalkResult:
    if kind == "mc":
        return run_walks_mc(gd, p, seed, n_anchors=n_anchors, max_steps=max_steps)
    return _kind_core(gd, p, seed, n_anchors=n_anchors, max_steps=max_steps, kind=kind)


def count_steps_taken(walks) -> None:
    """Add the steps of walk records to walk.steps_taken: a WalkResult, or a
    mesh rank's ShardedWalks (its own rows)."""
    count("walk.steps_taken", int(getattr(walks, "local", walks).steps.sum()))


def run_walks(gd: GraphDev, p: PlanDev, seed, *, n_anchors: int,
              max_steps: int) -> WalkResult:
    """Generic mixed-mode engine (any plan)."""
    return run_walks_kind(gd, p, seed, n_anchors=n_anchors, max_steps=max_steps,
                          kind="mixed")


# --- dispatch over plan sections -------------------------------------------------

def _slice_plan(p: WalkPlan, lo: int, hi: int) -> WalkPlan:
    return WalkPlan(start=p.start[lo:hi], first_edge=p.first_edge[lo:hi],
                    mode=p.mode[lo:hi], uid=p.uid[lo:hi], active=p.active[lo:hi])


def _slice_plan_padded(p: WalkPlan, lo: int, hi: int, w: int) -> WalkPlan:
    """Slice [lo, hi) and pad to w rows by repeating the last row INACTIVE; the
    caller drops the pad rows (draws depend only on seed, uid and step)."""
    rows = np.arange(lo, lo + w)
    idx = np.minimum(rows, hi - 1)
    return WalkPlan(start=p.start[idx], first_edge=p.first_edge[idx],
                    mode=p.mode[idx], uid=p.uid[idx],
                    active=p.active[idx] & (rows < hi), sections=None)


def prepare_plan_sections(plan: WalkPlan, device) -> list[tuple[str, PlanDev]]:
    """Slice a sectioned plan and upload each section to the device once."""
    if plan.sections is None:
        return [("mixed", plan_to_device(plan, device))]
    out = []
    for kind in ("greedy", "mc"):
        lo, hi = plan.sections[kind]
        if hi > lo:
            out.append((kind, plan_to_device(_slice_plan(plan, lo, hi), device)))
    return out


def _empty_result(max_steps: int, device) -> WalkResult:
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return WalkResult(nodes=z(0, max_steps + 1), eids=z(0, max_steps), steps=z(0),
                      success=torch.zeros(0, dtype=torch.bool, device=device),
                      terminal=z(0), path_len=z(0),
                      score_sum=torch.zeros(0, dtype=torch.float32, device=device))


def run_walks_prepared(gd: GraphDev, sections: list[tuple[str, PlanDev]], seed, *,
                       n_anchors: int, max_steps: int) -> WalkResult:
    """One specialised scan per device-resident section, concatenated back into
    plan row order; the span walk.dispatch."""
    if not sections:   # graph with no walkable anchor ends
        return _empty_result(max_steps, gd.wide.device)
    d, w = count_dispatch(sections, max_steps)
    if not profiler_running():
        return _run_sections(gd, sections, seed, n_anchors, max_steps)
    with span("walk.dispatch", dispatch=d, W=w, S=max_steps):
        return _run_sections(gd, sections, seed, n_anchors, max_steps)


def _run_sections(gd: GraphDev, sections: list[tuple[str, PlanDev]], seed, n_anchors: int,
                  max_steps: int) -> WalkResult:
    parts = [run_walks_kind(gd, pd, seed, n_anchors=n_anchors, max_steps=max_steps,
                            kind=kind) for kind, pd in sections]
    if len(parts) == 1:
        return parts[0]
    with span("walk.concat"):
        return WalkResult(*[torch.cat(a, dim=0) for a in zip(*parts)])


def run_walks_sectioned(gd: GraphDev, plan: WalkPlan, seed, *, n_anchors: int,
                        max_steps: int) -> WalkResult:
    """prepare_plan_sections + run_walks_prepared on the table's device."""
    return run_walks_prepared(gd, prepare_plan_sections(plan, gd.wide.device), seed,
                              n_anchors=n_anchors, max_steps=max_steps)


def run_walks_chunked(gd: GraphDev, plan: WalkPlan, seed, *, n_anchors: int,
                      max_steps: int, max_batch: int) -> WalkResult:
    """Run a plan in dispatches of <= max_batch rows within each section; every
    chunk's records move to host memory as it finishes, so the device holds one
    chunk at a time. Bit-equal to one dispatch (uid-keyed draws). A multi-chunk
    section pads its tail chunk to max_batch with inactive rows, as the
    reference does. Returns CPU tensors."""
    sections = (plan.sections or {None: (0, len(plan))}).items()
    parts: list[WalkResult] = []
    dev = gd.wide.device
    for kind, (lo, hi) in sorted(sections, key=lambda kv: kv[1][0]):
        multi = hi - lo > max_batch
        pos = lo
        while pos < hi:
            end = min(pos + max_batch, hi)
            keep = end - pos
            sub = (_slice_plan_padded(plan, pos, hi, max_batch) if multi
                   else _slice_plan(plan, pos, end))
            with span("walk.chunk", index=len(parts), kind=kind or "mixed", W=len(sub.start)):
                res = run_walks_prepared(gd, [(kind or "mixed", plan_to_device(sub, dev))], seed,
                                         n_anchors=n_anchors, max_steps=max_steps)
                with span("walk.download", W=keep):
                    parts.append(WalkResult(*[a[:keep].cpu() for a in res]))
                count_copy(parts[-1], dev, "cpu")
            pos = end
    if not parts:
        return _empty_result(max_steps, "cpu")
    return WalkResult(*[torch.cat(a, dim=0) for a in zip(*parts)])


def run_walks_host(g: GraphTensors, plan: WalkPlan, cfg: ScaffoldConfig,
                   device) -> WalkResult:
    """Single-device wrapper: host tables in, records on `device` out. Plans
    larger than cfg.max_walk_batch run in chunks (run_walks_chunked) and their
    records come back as host tensors: the device never holds more than one
    chunk of them (pipeline.py _consensus summarizes them chunk by chunk)."""
    gd = graph_to_device(g, device)
    if 0 < cfg.max_walk_batch < len(plan):
        return run_walks_chunked(gd, plan, cfg.mc_seed, n_anchors=g.n_anchors,
                                 max_steps=cfg.max_steps, max_batch=cfg.max_walk_batch)
    return run_walks_sectioned(gd, plan, cfg.mc_seed, n_anchors=g.n_anchors,
                               max_steps=cfg.max_steps)

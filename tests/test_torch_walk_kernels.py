"""The two walk kernels without Pallas twins, held by their algorithm on the CPU.

csrc/greedy_scan.cu (the reference's _kind_core: greedy and mixed sections) and
csrc/walk_events.cu (its _resolve_mc_events: MC event resolution) run only on
a card. So each is transcribed here, walk by walk and step by step, into numpy
(float32 and int32 scalars, sums that wrap as in C): the greedy scan's slots
strided over the lanes, its one valid bit a slot from the broadcast visited
test, the first maximum as an order-preserving uint32 key map, a warp max and
a warp min over the lanes that hold it, the pick from the owner lane (or a
second load for rows read in pages), the Threefry draw of a mixed section's MC
walks counted by ballots; the resolution's warp search in 32-step chunks
(ballots of dead rows and anchors, a lower lane's match, the earlier chunks'
path); and the streaming float32 step sum in XLA's row-reduce order
(csrc/walk_common.cuh StepSum). Each transcription is held by its bits against
the reference on CPU JAX (_run_walks_kind, _resolve_mc_events) and against the
port's plain torch versions, which the kernels are held to on the card
(tests/test_torch_pipeline.py, gpu marker, and chip_smoke.py). The dispatchers
run the plain versions on CPU tensors and reject what the kernels do not take."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rng import _kernel_threefry2x32
from test_walk import mk_graph, random_graph

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.pipeline import build_graph, load_inputs
from telomeri_tpu.sim import PRESETS, simulate, write_dataset
from telomeri_tpu.walk import engine as ref
from telomeri_tpu.walk.plan import MODE_GREEDY_ES, MODE_GREEDY_OS, MODE_MC, WalkPlan, plan_walks
from telomeri_tpu_torch import interop
from telomeri_tpu_torch.kernels import greedy_scan, walk_events, walk_scan, walk_table
from telomeri_tpu_torch.kernels.walk_common import MAX_STEPS, sum_steps
from telomeri_tpu_torch.walk import engine
from telomeri_tpu_torch.walk.rescue import RESCUE_UID_BASE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
F32 = np.float32
FIELDS = ("nodes", "eids", "steps", "success", "terminal", "path_len", "score_sum")


# --- the kernels, transcribed ---------------------------------------------------

class StepSum:
    """csrc/walk_common.cuh StepSum: one value a step, float32 adds, a level of
    32-wide windows above 32 values (pad // 2 zeros in front), never adding a
    padding zero."""

    LEVELS = 3

    def __init__(self, s: int):
        self.acc, self.pushed = [F32(0)] * self.LEVELS, [0] * self.LEVELS
        self.front, self.count, self.top = [0] * self.LEVELS, [0] * self.LEVELS, 0
        n = s
        for lvl in range(self.LEVELS):
            self.count[lvl] = n
            windows = (n + 31) // 32
            self.front[lvl] = (windows * 32 - n) // 2 if n > 32 else 0
            if lvl == self.top and n > 32 and lvl + 1 < self.LEVELS:
                self.top, n = lvl + 1, windows

    def add(self, v) -> None:
        v = F32(v)
        for lvl in range(self.LEVELS):
            self.acc[lvl] = F32(self.acc[lvl] + v)
            if lvl == self.top:
                return
            pos = self.pushed[lvl] + self.front[lvl]
            self.pushed[lvl] += 1
            if pos % 32 != 31 and self.pushed[lvl] != self.count[lvl]:
                return
            v, self.acc[lvl] = self.acc[lvl], F32(0)

    def result(self) -> np.float32:
        return self.acc[self.top]


KEY_NEG_INF = np.uint32(0x007FFFFF)   # csrc/greedy_scan.cu kKeyNegInf: key_order(-inf)


def _key_order(k) -> np.ndarray:
    """csrc/greedy_scan.cu key_order: float32 keys to uint32 in torch.argmax
    order (every NaN 0xFFFFFFFF, -0.0 as +0.0, then the sign-flip map)."""
    k = np.asarray(k, F32)
    b = np.where(k == 0, F32(0), k).view(np.uint32)
    u = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(k), np.uint32(0xFFFFFFFF), u)


def _slots_a_lane(h: int) -> int:
    """Groups of 32 slots a lane holds in registers (kG): a page of 32 * kG
    slots; rows wider than 512 slots are read in pages."""
    return 2 if h <= 64 else 4 if h <= 128 else 8 if h <= 256 else 16


def _warp_first_max(keys: np.ndarray) -> int:
    """The kernel's first maximum of one step over uint32 keys: lane l holds
    slots l, l + 32, ... (groups, and pages, in order) and keeps its own first
    maximum (strictly greater replaces, from 0, below every key); then
    __reduce_max_sync over the lanes and __reduce_min_sync over the slots of
    the lanes that hold it."""
    h = len(keys)
    lane = np.arange(32)
    best_key, best_slot = np.zeros(32, np.uint32), np.zeros(32, np.int64)
    for j0 in range(0, h, 32):
        j = j0 + lane
        k = keys[np.minimum(j, h - 1)]
        take = (j < h) & (k > best_key)
        best_key, best_slot = np.where(take, k, best_key), np.where(take, j, best_slot)
    top = best_key.max()
    return int(np.where(best_key == top, best_slot, 0xFFFFFFFF).min())


def _path_words(s_max: int) -> int:
    """int32 words of one warp's path in shared memory: S + 1, rounded up to 16 bytes."""
    return (s_max + 1 + 3) & ~3


def _u32(v) -> np.uint32:
    return np.uint32(int(v) & 0xFFFFFFFF)


def _draw(key: tuple, s: int) -> int:
    """walk_common.cuh draw_bits: word s % 2 of the block (2b, 2b + 1)."""
    y0, y1 = _kernel_threefry2x32(*key, _u32(s & ~1), _u32((s & ~1) + 1))
    return int(y1 if s & 1 else y0)


def greedy_kernel_np(wide, start, first_edge, mode, uid, active, seed, n_anchors, s_max, kind):
    """csrc/greedy_scan.cu, one walk (warp) at a time: the seven outputs. Each
    step reads the whole row once (slots strided over the lanes), tests every
    slot against the path by 16-byte broadcast reads (the entries past s are
    -1), keeps one valid bit a slot, and picks at the chosen slot: from the
    owner lane's registers, or (rows read in pages) by a second load with the
    path tested again."""
    n, h = wide.shape[0], wide.shape[1] // 6
    paged = h > 32 * _slots_a_lane(h)
    w = len(start)
    nodes = np.full((w, s_max + 1), -1, np.int32)
    eids = np.full((w, s_max), -1, np.int32)
    steps, terminal, path_len = (np.zeros(w, np.int32) for _ in range(3))
    success, score_sum = np.zeros(w, bool), np.zeros(w, F32)
    ramp = -np.arange(h, dtype=F32)
    for i in range(w):
        visited, walk_eids = np.full(_path_words(s_max), -1, np.int32), eids[i]
        visited[0] = start[i]
        by_os, mc = mode[i] == MODE_GREEDY_OS, kind == "mixed" and mode[i] == MODE_MC
        key = _kernel_threefry2x32(np.uint32(0), _u32(seed), np.uint32(0), _u32(uid[i])) \
            if mc else None
        done, hit, cur, n_taken, term, plen = not active[i], False, int(start[i]), 0, -1, 0
        total_sum = StepSum(s_max)
        s = 0
        while s < s_max and not done:
            row = wide[cur + n if cur < 0 else cur]
            nbr = row[:h]
            valid = (nbr >= 0) & ~np.isin(nbr, visited[:4 * (s // 4) + 4])
            if mc:
                total = int(row[2 * h - 1])
                r = (_draw(key, s) & 0x7FFFFFFF) % max(total, 1)
                cum = row[h:2 * h]   # __popc of one ballot a group of 32 slots
                count = sum(int((cum[j0:j0 + 32] <= r).sum()) for j0 in range(0, h, 32))
                choice, dead = min(count, h - 1), total <= 0
            else:
                keys = row[5 * h:].view(F32) if by_os else ramp
                choice = _warp_first_max(np.where(valid, _key_order(keys), KEY_NEG_INF))
                dead = not valid.any()
            forced = s == 0 and first_edge[i] >= 0
            if forced:
                choice = int(first_edge[i])
            inside = 0 <= choice < h
            nxt, e_id, e_adv, e_es = ((int(row[b * h + choice]) for b in (0, 2, 3, 4))
                                      if inside else (0, 0, 0, 0))
            if paged:
                ok = inside and nxt >= 0 and nxt not in visited[:s + 1]
            else:
                ok = inside and bool(valid[choice])
            if forced:
                dead = not ok
            if mc:
                dead = dead or not ok
            if not dead:
                hit, cur, n_taken = nxt < 2 * n_anchors, nxt, n_taken + 1
                plen = (plen + e_adv) & 0xFFFFFFFF
                visited[s + 1], walk_eids[s] = nxt, e_id
                if hit:
                    term = nxt
            total_sum.add(F32(0) if dead else np.int32(e_es).view(F32))
            done = dead or hit
            s += 1
        for _ in range(s, s_max):
            total_sum.add(0)
        nodes[i] = visited[:s_max + 1]
        steps[i], success[i], terminal[i] = n_taken, hit, term
        path_len[i], score_sum[i] = np.uint32(plen).view(np.int32), total_sum.result()
    return nodes, eids, steps, success, terminal, path_len, score_sum


def _lower_lane_match(v: np.ndarray) -> np.ndarray:
    """__match_any_sync(v) & lanemask_lt: a lower lane holds the same value."""
    return np.array([(v[:lane] == v[lane]).any() for lane in range(len(v))])


def resolve_kernel_np(start, active, nxt, total, eid, adv, es_bits, n_anchors, s_max):
    """csrc/walk_events.cu, one walk (warp) at a time: the seven outputs. The
    search goes in 32-step chunks (lane = step) up to the chunk of the event:
    kill = dead row, or a revisit of start (at S > 32, of the path kept in
    shared memory: start and the earlier chunks' nodes) or of a lower lane's
    node; anchor = nxt < 2 * n_anchors; the event is the lowest of either, a
    kill winning its step. Then the taken lanes' eid / adv / es, path_len by a
    warp sum (int32, wrapping), and score_sum: at S <= 32 a sequential sum of
    the taken steps (in the kernel lane k of a tile sums walk k's row), above
    it StepSum over every step."""
    w = len(start)
    nodes = np.full((w, s_max + 1), -1, np.int32)
    eids = np.full((w, s_max), -1, np.int32)
    steps, terminal, path_len = (np.zeros(w, np.int32) for _ in range(3))
    success, score_sum = np.zeros(w, bool), np.zeros(w, F32)
    es = es_bits.view(F32)
    lane = np.arange(32)
    for i in range(w):
        path = np.full(_path_words(s_max), -1, np.int32)   # the long kernel's shared path
        path[0] = start[i]
        n_taken, hit, term = s_max if active[i] else 0, False, -1
        c0 = 0
        while c0 < n_taken:   # the short kernel runs its one chunk for every walk
            t = c0 + lane
            inn = t < s_max
            v = np.where(inn, nxt[i, np.minimum(t, s_max - 1)], -1)
            tot = np.where(inn, total[i, np.minimum(t, s_max - 1)], 1)
            rev = (v == start[i]) if s_max <= 32 else np.isin(v, path[:c0 + 1])
            kills = ((tot <= 0) | rev | _lower_lane_match(v)) & inn
            events = kills | ((v < 2 * n_anchors) & inn)
            path[c0 + 1:c0 + 1 + int(inn.sum())] = v[inn]
            if events.any():
                t_ev = int(np.argmax(events))
                hit = not kills[t_ev]
                n_taken = c0 + t_ev + 1 if hit else c0 + t_ev
                term = int(v[t_ev]) if hit else -1
            c0 += 32
        took = np.arange(s_max) < n_taken
        nodes[i, 0] = start[i]
        nodes[i, 1:] = np.where(took, nxt[i], -1)
        eids[i] = np.where(took, eid[i], -1)
        plen = int(np.where(took, adv[i], 0).astype(np.int64).sum()) & 0xFFFFFFFF
        if s_max <= 32:
            acc = F32(0)
            for t in range(n_taken):
                acc = F32(acc + es[i, t])
        else:
            acc_sum = StepSum(s_max)
            for t in range(s_max):
                acc_sum.add(es[i, t] if t < n_taken else 0)
            acc = acc_sum.result()
        steps[i], success[i], terminal[i] = n_taken, hit, term
        path_len[i], score_sum[i] = np.uint32(plen).view(np.int32), acc
    return nodes, eids, steps, success, terminal, path_len, score_sum


# --- comparison helpers ----------------------------------------------------------

def assert_same(want, got, what=""):
    """Seven outputs equal, dtype and shape included; score_sum by its bits."""
    for f, a, b in zip(FIELDS, want, got):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        if f == "score_sum":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {f}")


def _check_greedy(g_ref, plan, seed, s_max, kind):
    """The transcription against the reference's _run_walks_kind and the port's
    plain version (through the CPU dispatcher) on one plan."""
    gd = ref.graph_to_device(g_ref)
    want = ref._run_walks_kind(gd, ref.plan_to_device(plan), seed,
                               n_anchors=g_ref.n_anchors, max_steps=s_max, kind=kind)
    wide = np.asarray(gd.wide)
    got = greedy_kernel_np(wide, plan.start, plan.first_edge, plan.mode, plan.uid, plan.active,
                           seed, g_ref.n_anchors, s_max, kind)
    assert_same(want, got, f"{kind} S={s_max}")
    plain = greedy_scan.greedy_scan(torch.from_numpy(wide.copy()),
                                    interop.plan_dev_from_numpy(plan), seed, g_ref.n_anchors,
                                    s_max, kind)
    assert_same(got, plain, f"plain {kind} S={s_max}")
    return got


def _check_resolve(start, active, recs, n_nodes: tuple, n_anchors, s_max):
    """The transcription against the reference's _resolve_mc_events and the
    port's plain version (through the CPU dispatcher) on one set of records,
    with each of the given node counts (which pick their revisit branch)."""
    w = len(start)
    pd = ref.PlanDev(start=jnp.asarray(start), first_edge=jnp.full(w, -1, jnp.int32),
                     mode=jnp.full(w, MODE_MC, jnp.int32), uid=jnp.arange(w, dtype=jnp.int32),
                     active=jnp.asarray(active))
    got = resolve_kernel_np(start, active, *recs, n_anchors, s_max)
    for n in n_nodes:
        want = ref._resolve_mc_events(pd, *[jnp.asarray(a) for a in recs], n_nodes=n,
                                      n_anchors=n_anchors, max_steps=s_max)
        assert_same(want, got, f"resolve S={s_max} n_nodes={n}")
        plain = walk_events.resolve_events(torch.from_numpy(start), torch.from_numpy(active),
                                           *[torch.from_numpy(a) for a in recs], n_nodes=n,
                                           n_anchors=n_anchors, max_steps=s_max)
        assert_same(got, plain, f"plain resolve n_nodes={n}")
    return got


def _scan_records(g_ref, plan, seed, s_max):
    """The MC scan's (5, W, S) records of the plan's rows (the port's plain scan
    over the reference's draw table), as numpy planes."""
    wide = torch.from_numpy(np.array(ref.graph_to_device(g_ref).wide))
    bits = np.asarray(ref._stable_bits_table(seed, jnp.asarray(plan.uid), s_max)).view(np.int32)
    recs = walk_scan.walk_scan_torch(wide, torch.from_numpy(plan.start),
                                     torch.from_numpy(bits), s_max)
    return [recs[k].numpy() for k in range(5)]


def _rows(p: WalkPlan, idx) -> WalkPlan:
    return WalkPlan(start=p.start[idx], first_edge=p.first_edge[idx], mode=p.mode[idx],
                    uid=p.uid[idx], active=p.active[idx])


# --- datasets ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def lambda_problem():
    with open(os.path.join(LAMBDA, "config.json")) as f:
        cfg = ScaffoldConfig(**json.load(f))
    contigs, reads, paf = load_inputs(*[os.path.join(LAMBDA, f) for f in INPUTS])
    _, graph = build_graph(contigs, reads, paf, cfg)
    return cfg, graph, plan_walks(graph, cfg)


@pytest.fixture(scope="module")
def ecoli_problem(tmp_path_factory):
    """The E. coli preset's read and repeat model on a tenth of its genome (the
    whole preset takes about a minute to simulate), with the default config;
    its plan cut to a few thousand walks: every greedy walk, then MC walks."""
    d = str(tmp_path_factory.mktemp("ecoli_tenth"))
    sim = dataclasses.replace(PRESETS["ecoli"], genome_len=460_000, n_repeat_copies=4)
    write_dataset(simulate(sim), d)
    cfg = ScaffoldConfig()
    contigs, reads, paf = load_inputs(*[os.path.join(d, f) for f in INPUTS])
    _, graph = build_graph(contigs, reads, paf, cfg)
    plan = plan_walks(graph, cfg)
    lo, hi = plan.sections["greedy"]
    mc_lo, mc_hi = plan.sections["mc"]
    keep = np.concatenate([np.arange(lo, hi), np.arange(mc_lo, min(mc_hi, mc_lo + 2000))])
    return cfg, graph, plan, _rows(plan, keep), hi - lo


# --- the greedy / mixed scan -------------------------------------------------------

@pytest.mark.parametrize("kind", ["greedy", "mixed"])
def test_greedy_kernel_on_lambda(lambda_problem, kind):
    cfg, graph, plan = lambda_problem
    if kind == "greedy":
        lo, hi = plan.sections["greedy"]
        plan = _rows(plan, np.arange(lo, hi))
    got = _check_greedy(graph, plan, cfg.mc_seed, cfg.max_steps, kind)
    assert got[3].any()


@pytest.mark.parametrize("kind", ["greedy", "mixed"])
def test_greedy_kernel_on_the_ecoli_model(ecoli_problem, kind):
    cfg, graph, _, cut, n_greedy = ecoli_problem
    assert walk_table.lane_width(graph.nbr.shape[1]) == 64 and len(cut) > 2000
    if kind == "greedy":
        cut = _rows(cut, np.arange(n_greedy))
    got = _check_greedy(graph, cut, cfg.mc_seed, cfg.max_steps, kind)
    assert got[3].any() and (~got[3]).any()


@pytest.mark.parametrize("k", [8, 100, 200], ids=["H64", "H128", "H256"])
@pytest.mark.parametrize("s_max", [1, 24, 32, 33, 48, 96])
def test_greedy_kernel_at_every_shape(rng, s_max, k):
    """Greedy and mixed sections at S = 1 ... 96 and H = 64, 128, 256, with
    rescue uids and a negative seed in the mixed one."""
    g = random_graph(rng, n_seqs=max(60, k), k=k)
    assert walk_table.lane_width(g.nbr.shape[1]) == {8: 64, 100: 128, 200: 256}[k]
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=2, max_steps=s_max))
    (lo, hi), (mc_lo, mc_hi) = plan.sections["greedy"], plan.sections["mc"]
    greedy = np.arange(lo, hi)[::max(1, (hi - lo) // 24)]   # 24 of the first edges
    _check_greedy(g, _rows(plan, greedy), 3, s_max, "greedy")
    plan = _rows(plan, np.concatenate([greedy, np.arange(mc_lo, mc_hi)]))
    plan.uid[len(plan) // 2:] += RESCUE_UID_BASE
    _check_greedy(g, plan, -7 if s_max % 2 else -2**31, s_max, "mixed")


def _argmax_rows(rng, h: int) -> list:
    """(name, keys, valid) rows for the first maximum: NaN of both signs, -0.0
    against +0.0, +-inf, ties, all-invalid rows, valid slots keyed -inf."""
    nan_neg = np.array([0xFFC00000], np.uint32).view(F32)[0]
    base = rng.standard_normal(h).astype(F32)
    rows = []
    for name in ("plain", "nan", "neg_nan", "two_nans", "zeros", "neg_zero_first", "pos_inf",
                 "neg_inf_valid", "ties", "all_invalid", "all_neg_inf", "last_slot"):
        k, valid = base.copy(), rng.random(h) < 0.7
        if name == "nan":
            k[rng.integers(0, h)] = np.nan
        elif name == "neg_nan":
            k[rng.integers(0, h)] = nan_neg
        elif name == "two_nans":
            k[[h // 3, h - 5]] = [nan_neg, np.nan]
            valid[[h // 3, h - 5]] = True
        elif name == "zeros":
            k[:] = 0.0
            k[::3] = -0.0
        elif name == "neg_zero_first":
            k[:] = -1.0
            k[[7, 40]] = [-0.0, 0.0]
            valid[[7, 40]] = True
        elif name == "pos_inf":
            k[[h - 1, 33]] = np.inf
        elif name == "neg_inf_valid":
            k[:] = -np.inf
            valid[:5] = [False, False, True, False, True]
        elif name == "ties":
            k = rng.integers(0, 3, h).astype(F32)
        elif name == "all_invalid":
            valid[:] = False
        elif name == "all_neg_inf":
            k[:], valid[:] = -np.inf, True
        elif name == "last_slot":
            k[:] = -2.0
            k[h - 1], valid[h - 1] = 5.0, True
        rows.append((name, k, valid))
    return rows


@pytest.mark.parametrize("h", [64, 128, 256, 512, 1024])
def test_first_maximum_matches_torch_argmax(rng, h):
    """The greedy scan's key map and warp first maximum against torch.argmax of
    the reference's masked keys (-inf where not valid), and the key map against
    float order (NaN above +inf, -0.0 equal to +0.0)."""
    for name, k, valid in _argmax_rows(rng, h):
        masked = np.where(valid, k, F32(-np.inf)).astype(F32)
        want = int(torch.argmax(torch.from_numpy(masked)))
        got = _warp_first_max(np.where(valid, _key_order(k), KEY_NEG_INF))
        assert got == want, (h, name)
        assert _warp_first_max(_key_order(masked)) == want, (h, name)
        ramp = np.where(valid, _key_order(-np.arange(h, dtype=F32)), KEY_NEG_INF)
        assert _warp_first_max(ramp) == (int(np.argmax(valid)) if valid.any() else 0), (h, name)
    x = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-45, 2.0, np.inf, np.nan], F32)
    u = _key_order(x)
    assert (np.diff(u[[0, 1, 2, 4, 5, 6, 7]].astype(np.int64)) > 0).all()
    assert u[2] == u[3] and u[7] == _key_order(np.array([0xFFC00001], np.uint32).view(F32))[0]
    assert u[0] == KEY_NEG_INF


def test_greedy_kernel_on_rows_read_in_pages(rng):
    """H = 1024: rows wider than 512 slots, read in two pages, the pick a second
    load with the path tested again; greedy and mixed sections."""
    g = random_graph(rng, n_seqs=600, k=600)
    assert walk_table.lane_width(g.nbr.shape[1]) == 1024
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=1, max_steps=12))
    (lo, hi), (mc_lo, mc_hi) = plan.sections["greedy"], plan.sections["mc"]
    greedy = np.arange(lo, hi)[::max(1, (hi - lo) // 16)]
    _check_greedy(g, _rows(plan, greedy), 5, 12, "greedy")
    mixed = np.concatenate([greedy, np.arange(mc_lo, mc_hi)[::max(1, (mc_hi - mc_lo) // 16)]])
    _check_greedy(g, _rows(plan, mixed), -9, 12, "mixed")


def _edge_case_table():
    """A hand table of 12 nodes, 2 anchors (nodes 0-3), K = 5 (H = 64). Rows are
    sorted by ES, so slot j is the j-th entry below by ES. Node 1 has an edge
    to itself (slot 2); node 4 three equal OS keys; node 5 leads only back to
    nodes a walk through it has seen; node 6 has no edges; node 7 a NaN OS key
    (slot 1); node 8 leads back to 4 and 5; node 9's weights are zero (an MC
    dead row)."""
    rows = {
        0: [(4, 9.0, 2.0, 10), (7, 8.0, 1.0, 11), (6, 7.0, 3.0, 12), (9, 1.0, 0.5, 13)],
        1: [(5, 9.0, 2.0, 10), (8, 3.0, 2.0, 20), (1, 0.5, 9.0, 14)],
        4: [(8, 5.0, 6.0, 30), (5, 4.0, 6.0, 31), (10, 3.0, 6.0, 32), (2, 1.0, 1.0, 33)],
        5: [(4, 5.0, 1.0, 40), (8, 4.0, 2.0, 41)],
        7: [(11, 6.0, 7.0, 51), (5, 3.0, 1.0, 52), (10, 2.0, 1.0, 50)],
        8: [(4, 6.0, 1.0, 60), (5, 5.0, 2.0, 61), (2, 1.0, 0.1, 62)],
        9: [(10, 0.0, 1.0, 70), (11, 0.0, 2.0, 71)],
        10: [(3, 2.0, 1.0, 80), (0, 1.0, 1.0, 81)],
        11: [(7, 2.0, 1.0, 90)],
    }
    g = mk_graph(12, 2, 5, rows)
    g.os_[7, 1] = np.nan
    return g


# (start, first_edge, mode, active) of the edge-case walks
EDGE_CASE_WALKS = (
    (0, -1, MODE_GREEDY_OS, True), (0, 0, MODE_GREEDY_OS, True), (0, 1, MODE_GREEDY_ES, True),
    (1, -1, MODE_GREEDY_ES, False), (1, 1, MODE_GREEDY_OS, True),
    (0, 64 + 3, MODE_GREEDY_ES, True),   # past H: reads nothing, picks nbr 0, dead
    (0, 4, MODE_GREEDY_OS, True),        # a pad slot (nbr -1): dead
    (1, 2, MODE_GREEDY_ES, True),        # onto the start itself: a revisit, dead
    (0, 2, MODE_GREEDY_OS, True),        # onto node 6, whose row is all invalid
    (7, -1, MODE_GREEDY_OS, True),       # the NaN key wins
    (4, -1, MODE_GREEDY_OS, True),       # equal keys: the first slot
    (5, -1, MODE_GREEDY_ES, True), (6, -1, MODE_GREEDY_OS, True),
    (9, -1, MODE_MC, True),              # an MC walk on a dead row
    (0, -1, MODE_MC, True), (1, -1, MODE_MC, True), (8, -1, MODE_MC, True),
    (5, -1, MODE_MC, False), (11, -1, MODE_GREEDY_ES, True), (10, -1, MODE_MC, True),
)


@pytest.mark.parametrize("kind", ["greedy", "mixed"])
def test_greedy_kernel_edge_cases(kind):
    """Equal OS keys, a NaN key, all-invalid and edgeless rows, forced first
    edges out of range (past H, on a pad slot, onto the start), inactive walks,
    MC walks on a dead row and into revisits, negative seeds, rescue uids."""
    g = _edge_case_table()
    assert walk_table.lane_width(g.nbr.shape[1]) == 64
    start, first, mode, active = (np.array(c) for c in zip(*EDGE_CASE_WALKS))
    uid = np.arange(len(start), dtype=np.int32)
    uid[::3] += RESCUE_UID_BASE
    plan = WalkPlan(start=start.astype(np.int32), first_edge=first.astype(np.int32),
                    mode=mode.astype(np.int32), uid=uid, active=active.astype(bool))
    for seed in (0, -1, 12345):
        steps = _check_greedy(g, plan, seed, 6, kind)[2]
        assert not steps[~plan.active].any()   # inactive walks never step
        assert not steps[5:8].any()            # the three dead first edges


# --- MC event resolution -------------------------------------------------------------

def _planted_records(rng, w, s, n_anchors, n_nodes):
    """Records with every event class planted at random steps: revisits of the
    start and of an interior node, dead rows on which the walk stays (total 0,
    nxt -1 at every later step: -1 duplicates), anchor hits, a kill at the
    step of an anchor hit, inactive walks, and walks with no event at all."""
    lo = 2 * n_anchors
    nxts = rng.integers(lo, n_nodes, (w, s)).astype(np.int32)
    start = rng.integers(lo, n_nodes, w).astype(np.int32)
    totals = rng.integers(1, 5, (w, s)).astype(np.int32)
    at = rng.integers(0, s, w)
    cls = np.arange(w) % 7
    for i in range(w):
        t = at[i]
        if cls[i] == 0:
            nxts[i, t] = start[i]
        elif cls[i] == 1 and t > 0:
            nxts[i, t] = nxts[i, rng.integers(0, t)]
        elif cls[i] == 2:
            totals[i, t:] = 0
            nxts[i, t:] = -1
        elif cls[i] == 3:
            nxts[i, t] = rng.integers(0, lo)
        elif cls[i] == 4:
            nxts[i, t] = rng.integers(0, lo)
            totals[i, t] = 0
        elif cls[i] == 5:
            nxts[i, t] = rng.integers(0, lo)
            if t > 0:
                nxts[i, t - 1] = start[i]
    eids = rng.integers(-1, 1000, (w, s)).astype(np.int32)
    adv = rng.integers(0, 2**30, (w, s)).astype(np.int32)   # the int32 sum wraps
    es = (rng.standard_normal((w, s)) * rng.uniform(0.1, 100, (w, s))).astype(F32)
    active = rng.random(w) < 0.9
    return start, active, [nxts, totals, eids, adv, es.view(np.int32)]


@pytest.mark.parametrize("n_nodes", [50_000, 40_000_000], ids=["packed", "pairwise"])
@pytest.mark.parametrize("s_max", [1, 12, 24, 32, 33, 48, 96])
def test_resolve_kernel_on_planted_events(rng, s_max, n_nodes):
    """n_nodes 40M puts the reference on its pairwise revisit branch, 50,000 on
    the packed sort; the kernel takes neither and agrees with both."""
    start, active, recs = _planted_records(rng, 210, s_max, 8, n_nodes)
    got = _check_resolve(start, active, recs, (n_nodes,), 8, s_max)
    assert got[3].any() and (got[2] < s_max).any()


@pytest.mark.parametrize("s_max", [33, 64, 96])
def test_resolve_kernel_revisits_across_a_chunk_boundary(rng, s_max):
    """Events past the first 32-step chunk, each walk with none before it: a
    step onto the start, onto a node of the first chunk, onto a lower lane of
    its own chunk (or the chunk before's last node), onto a node of the chunk
    before its own (revisits found through the earlier chunks' path), and
    anchor hits."""
    w, n_anchors = 120, 8
    lo = 2 * n_anchors
    start = (lo + np.arange(w)).astype(np.int32)
    nxts = np.empty((w, s_max), np.int32)
    for i in range(w):   # distinct nodes a row, none of them the start
        nxts[i] = rng.choice(np.arange(lo + w, lo + w + 10 * s_max), s_max, replace=False)
    totals = np.ones((w, s_max), np.int32)
    at = 32 + rng.integers(0, s_max - 32, w)   # the event's step, past the first chunk
    for i in range(w):
        t = at[i]
        kind = i % 5
        if kind == 0:
            nxts[i, t] = start[i]
        elif kind == 1:
            nxts[i, t] = nxts[i, rng.integers(0, 32)]
        elif kind == 2:   # a lower lane of its own chunk, or the chunk before's last
            nxts[i, t] = nxts[i, t - 1 - rng.integers(0, t % 32 + 1)]
        elif kind == 3:   # a node of the chunk before its own
            nxts[i, t] = nxts[i, rng.integers(32 * (t // 32) - 32, 32 * (t // 32))]
        else:
            nxts[i, t] = rng.integers(0, lo)
    eids = rng.integers(-1, 1000, (w, s_max)).astype(np.int32)
    adv = rng.integers(0, 2**30, (w, s_max)).astype(np.int32)
    es = (rng.standard_normal((w, s_max)) * 10).astype(F32)
    active = np.ones(w, bool)
    recs = [nxts, totals, eids, adv, es.view(np.int32)]
    got = _check_resolve(start, active, recs, (50_000, 40_000_000), n_anchors, s_max)
    steps, success = got[2], got[3]
    kill = np.arange(w) % 5 != 4
    assert (steps[kill] == at[kill]).all() and not success[kill].any()
    assert (steps[~kill] == at[~kill] + 1).all() and success[~kill].all()


def test_resolve_kernel_on_lambda_and_the_ecoli_model(lambda_problem, ecoli_problem):
    for cfg, graph, plan in (lambda_problem, ecoli_problem[:3]):
        lo, hi = plan.sections["mc"]
        sub = _rows(plan, np.arange(lo, min(hi, lo + 2000)))
        recs = _scan_records(graph, sub, cfg.mc_seed, cfg.max_steps)
        # both sides of the packing limit (mult 64 at S <= 63)
        got = _check_resolve(sub.start, sub.active, recs, (graph.nbr.shape[0], 2**31 // 64),
                             graph.n_anchors, cfg.max_steps)
        assert got[3].any() and (~got[3]).any()


@pytest.mark.parametrize("k", [100, 200], ids=["H128", "H256"])
@pytest.mark.parametrize("s_max", [1, 33, 48, 96])
def test_resolve_kernel_on_scanned_records(rng, s_max, k):
    """Records of the MC scan on wider rows, with rescue uids and negative seeds."""
    g = random_graph(rng, n_seqs=max(80, k), k=k)
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=8, max_steps=s_max))
    lo, hi = plan.sections["mc"]
    sub = _rows(plan, np.arange(lo, hi))
    sub.uid[::2] += RESCUE_UID_BASE
    recs = _scan_records(g, sub, -5 - s_max, s_max)
    _check_resolve(sub.start, sub.active, recs, (g.nbr.shape[0],), g.n_anchors, s_max)


# --- long walks -----------------------------------------------------------------------

def _forward_chain_graph(n_nodes=700, k=3):
    """Edges only forward (node u to the next k nodes), so no walk revisits and
    walks run for hundreds of steps: the four anchor nodes lead in, the last
    node leads back to anchor 0 (an anchor hit at the end of the line)."""
    rng = np.random.default_rng(11)
    rows = {}
    for u in range(n_nodes - 1):
        lo = max(u + 1, 4)
        rows[u] = [(d, float(F32(rng.uniform(0.5, 50))), float(F32(rng.uniform(0.5, 50))),
                    int(rng.integers(1, 500))) for d in range(lo, min(lo + k, n_nodes))]
    rows[n_nodes - 1] = [(0, 1.0, 1.0, 7)]
    return mk_graph(n_nodes, 2, k, rows)


@pytest.mark.parametrize("kind", ["greedy", "mixed", "mc"])
def test_kernels_on_walks_hundreds_of_steps_long(kind):
    """S = 512, where 64 walks' rows no longer fit one block's 48 KB of shared
    memory and the kernels take fewer walks a block: paths of up to 512 steps
    in the visited test and the revisit test, and score sums over 16 windows."""
    g = _forward_chain_graph()
    s_max = 512
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=6, max_steps=s_max))
    lo, hi = plan.sections["mc" if kind == "mc" else "greedy"]
    sub = _rows(plan, np.arange(lo, hi))
    sub.active[::7] = False
    if kind == "mc":
        recs = _scan_records(g, sub, 5, s_max)
        got = _check_resolve(sub.start, sub.active, recs, (g.nbr.shape[0],), g.n_anchors, s_max)
    else:
        if kind == "mixed":
            sub = _rows(plan, np.arange(len(plan)))
            sub.uid[1::2] += RESCUE_UID_BASE
        got = _check_greedy(g, sub, -3, s_max, kind)
    steps = got[2][sub.active]
    assert steps.max() > 300 and got[3].any()


# --- the step sum --------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [range(1, 33), range(33, 97), range(97, 161),
                                   (1023, 1024, 1025, 1100, 2049)],
                         ids=["1-32", "33-96", "97-160", "above-1024"])
def test_step_sum_matches_the_xla_order(sizes):
    """StepSum (one value a step, as the kernels feed it) against sum_steps
    (walk_common.py sum_steps), which tests/test_torch_walk.py holds to XLA's own
    row sum: every S of the range, and S past 32 * 32 where the window sums
    get windows of their own."""
    rng = np.random.default_rng(len(sizes))
    for s in sizes:
        x = (rng.standard_normal((3, s)) * rng.uniform(0.1, 100, (3, s))).astype(F32)
        x[rng.random((3, s)) < 0.3] = 0.0
        want = sum_steps(torch.from_numpy(x)).numpy()
        for row, v in zip(x, want):
            acc = StepSum(s)
            for e in row:
                acc.add(e)
            assert acc.result().view(np.int32) == v.view(np.int32), f"S={s}"


# --- the dispatchers --------------------------------------------------------------

def _small_problem(rng, s_max=9):
    g = random_graph(rng)
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=4, max_steps=s_max))
    gd = walk_table.graph_to_device(interop.graph_from_reference(g), "cpu")
    return g, plan, gd, interop.plan_dev_from_numpy(plan)


def test_dispatchers_run_the_plain_versions_on_cpu_tensors(rng):
    """On CPU tensors no kernel launches: the dispatchers and the engine's
    entry points return the plain versions' results."""
    from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts

    g, plan, gd, pd = _small_problem(rng)
    reset_launch_counts()
    for kind in ("greedy", "mixed"):
        want = greedy_scan.greedy_scan_torch(gd.wide, pd, 4, g.n_anchors, 9, kind)
        assert_same(want, greedy_scan.greedy_scan(gd.wide, pd, 4, g.n_anchors, 9, kind))
        assert_same(want, engine._kind_core(gd, pd, 4, n_anchors=g.n_anchors, max_steps=9,
                                            kind=kind))
    recs = walk_scan.walk_scan(gd.wide, pd.start, pd.uid, 4, 9)
    kw = dict(n_nodes=int(gd.wide.shape[0]), n_anchors=g.n_anchors, max_steps=9)
    want = walk_events.resolve_events_torch(pd.start, pd.active, *recs, **kw)
    assert_same(want, walk_events.resolve_events(pd.start, pd.active, *recs, **kw))
    assert_same(want, engine.resolve_mc_events(pd, *recs, **kw))
    assert all(v == 0 for v in launch_counts().values())


def _bad_greedy_inputs(gd, pd):
    narrow = torch.zeros((gd.wide.shape[0], 6 * 32), dtype=torch.int32)   # H = 32
    return {
        "dtype": (gd.wide, pd._replace(start=pd.start.long()), 9, "start"),
        "shape": (gd.wide, pd._replace(active=pd.active[1:]), 9, "active"),
        "device": (gd.wide, pd._replace(uid=pd.uid.to("meta")), 9, "one device"),
        "H": (narrow, pd, 9, "H % 64"),
        "steps": (gd.wide, pd, 0, "max_steps"),
        "too_long": (gd.wide, pd, MAX_STEPS + 1, "max_steps"),
        "cpu": (gd.wide, pd, 9, "CUDA"),
    }


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "H", "steps", "too_long", "cpu"])
def test_greedy_kernel_wrapper_rejects_what_the_kernel_does_not_take(rng, case):
    g, _, gd, pd = _small_problem(rng)
    wide, plan, s_max, match = _bad_greedy_inputs(gd, pd)[case]
    with pytest.raises(ValueError, match=match):
        greedy_scan.greedy_scan_cuda(wide, plan, 0, g.n_anchors, s_max, "greedy")
    with pytest.raises(ValueError, match="mixed or greedy"):
        greedy_scan.greedy_scan_cuda(gd.wide, pd, 0, g.n_anchors, 9, "mc")


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "steps", "too_long", "cpu"])
def test_resolve_kernel_wrapper_rejects_what_the_kernel_does_not_take(rng, case):
    g, _, gd, pd = _small_problem(rng)
    recs = list(walk_scan.walk_scan(gd.wide, pd.start, pd.uid, 4, 9))
    start, active, s_max, match = pd.start, pd.active, 9, "CUDA"
    if case == "dtype":
        recs[2], match = recs[2].long(), "eids"
    elif case == "shape":
        active, match = active[1:], "active"
    elif case == "device":
        recs[4], match = recs[4].to("meta"), "one device"
    elif case == "steps":
        recs, s_max, match = [r[:, :0] for r in recs], 0, "max_steps"
    elif case == "too_long":   # past the step sum's three levels of windows
        s_max, match = MAX_STEPS + 1, "max_steps"
        start, active = start[:2], active[:2]
        recs = [torch.zeros((2, s_max), dtype=torch.int32) for _ in recs]
    with pytest.raises(ValueError, match=match):
        walk_events.resolve_events_cuda(start, active, *recs, n_anchors=g.n_anchors,
                                        max_steps=s_max)


def test_dispatchers_never_fall_back(rng):
    """A table or records on a device with no path raise; they never run the
    plain version instead."""
    g, _, gd, pd = _small_problem(rng)
    meta = pd._replace(**{f: getattr(pd, f).to("meta") for f in pd._fields})
    with pytest.raises(ValueError, match="no greedy-scan path"):
        greedy_scan.greedy_scan(gd.wide.to("meta"), meta, 0, g.n_anchors, 9, "greedy")
    recs = [r.to("meta") for r in walk_scan.walk_scan(gd.wide, pd.start, pd.uid, 4, 9)]
    with pytest.raises(ValueError, match="no event-resolution path"):
        walk_events.resolve_events(meta.start, meta.active, *recs, n_nodes=100,
                                   n_anchors=g.n_anchors, max_steps=9)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/walk_common.cuh, which three sources include, names a
    new library: a stale build is never reused."""
    import shutil

    from telomeri_tpu_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    assert any(p.endswith("walk_common.cuh") for p in build._hashed())
    before = build.library_path()
    with open(csrc / "walk_common.cuh", "a") as f:
        f.write("\n// an edit\n")
    assert build.library_path() != before

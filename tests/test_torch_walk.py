"""The port's walk engine against the reference's, bit for bit: the MC section
(against the lax.scan engine and the Pallas scan in interpret mode), greedy and
mixed sections, sectioned and chunked dispatch, both revisit branches of the MC
event resolution, the scalar oracle, and score_sum in XLA's row-reduce order
above 32 steps. On CPU tensors the walk-scan wrapper runs its plain torch
version; the CUDA kernel is held against that version on the card
(test_torch_pipeline.py, gpu marker, and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_walk import _resolve_oracle, chain_graph, mk_graph, random_graph

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.kernels.walk_vmem import run_walks_mc_vmem
from telomeri_tpu.walk import engine as ref
from telomeri_tpu.walk.oracle import jax_choice_fn, walk_oracle
from telomeri_tpu.walk.plan import MODE_GREEDY_ES, MODE_GREEDY_OS, MODE_MC, plan_walks
from telomeri_tpu_torch import interop
from telomeri_tpu_torch.kernels import walk_common, walk_scan, walk_table
from telomeri_tpu_torch.walk import engine

# the reference's graph / plan / config as the port's classes
G, P, C = (interop.graph_from_reference, interop.plan_from_reference,
           interop.config_from_reference)


def assert_walks_equal(want, got):
    """Every WalkResult field equal; score_sum compared by its float32 bits."""
    want = interop.walk_result_to_numpy(want)
    got = interop.walk_result_to_numpy(got)
    for f, a, b in zip(want._fields, want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f == "score_sum":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f)


def _mc_section(g, p):
    lo, hi = p.sections["mc"]
    return ref._slice_plan(p, lo, hi)


def test_graph_tables_match_reference(rng):
    g = random_graph(rng)
    want = np.asarray(ref.graph_to_device(g).wide)
    via_interop = interop.graph_dev_from_numpy(want)
    own = walk_table.graph_to_device(G(g), "cpu")
    assert own.h == ref.graph_to_device(g).h
    np.testing.assert_array_equal(own.wide.numpy(), want)
    np.testing.assert_array_equal(via_interop.wide.numpy(), own.wide.numpy())


@pytest.mark.parametrize("seed", [7, 2**31 - 1])
def test_mc_section_matches_reference_and_pallas(rng, seed):
    g = random_graph(rng)
    p = plan_walks(g, ScaffoldConfig(mc_walks_per_end=16, max_steps=10))
    sub = _mc_section(g, p)
    gd_ref, pd_ref = ref.graph_to_device(g), ref.plan_to_device(sub)
    want = ref._run_walks_mc_fast(gd_ref, pd_ref, seed, n_anchors=g.n_anchors,
                                  max_steps=10)
    pallas = run_walks_mc_vmem(gd_ref, pd_ref, seed, n_anchors=g.n_anchors,
                               max_steps=10, tile=64, strategy="loop", interpret=True)
    got = engine.run_walks_mc(interop.graph_dev_from_numpy(np.asarray(gd_ref.wide)),
                              interop.plan_dev_from_numpy(pd_ref), seed,
                              n_anchors=g.n_anchors, max_steps=10)
    assert_walks_equal(want, got)
    assert_walks_equal(pallas, got)


def test_walk_scan_records_match_reference_scan(rng):
    """The five per-step records themselves, against the Pallas scan (interpret)."""
    from telomeri_tpu.kernels.walk_vmem import _vmem_scan

    g = random_graph(rng)
    p = plan_walks(g, ScaffoldConfig(mc_walks_per_end=16, max_steps=12))
    sub = _mc_section(g, p)
    gd = ref.graph_to_device(g)
    bits = ref._stable_bits_table(3, jnp.asarray(sub.uid), 12)
    want = _vmem_scan(gd, jnp.asarray(sub.start), jnp.transpose(bits), max_steps=12,
                      tile=len(sub), strategy="loop", interpret=True)
    wide = walk_table.graph_to_device(G(g), "cpu").wide
    got = walk_scan.walk_scan(wide, torch.from_numpy(sub.start), torch.from_numpy(sub.uid), 3, 12)
    given = walk_scan.walk_scan_torch(wide, torch.from_numpy(sub.start),
                                      torch.from_numpy(np.array(bits).view(np.int32)), 12)
    for k in range(5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=str(k))
        np.testing.assert_array_equal(given[k].numpy(), np.asarray(want[k]), err_msg=str(k))


@pytest.mark.parametrize("k", [8, 100], ids=["H64", "H128"])
@pytest.mark.parametrize("max_steps", [24, 32, 33, 48, 96])
def test_walk_scan_entry_matches_reference_mc_core(rng, max_steps, k):
    """walk_scan(wide, start, uid, seed, S), the entry the MC section calls (on a
    card: the kernel that draws for itself), against the reference's
    _mc_fast_core: its records equal the plain scan over the reference's own draw
    table, and the walks resolved from them equal the reference's, with rescue
    uids (>= 1 << 30) and a negative seed among the walks."""
    from telomeri_tpu_torch.walk.rescue import RESCUE_UID_BASE

    seed = -5 if max_steps == 33 else 2**31 - 1
    g = random_graph(rng, n_seqs=80, k=k)
    p = plan_walks(g, ScaffoldConfig(mc_walks_per_end=6, max_steps=max_steps))
    sub = _mc_section(g, p)
    sub.uid[len(sub) // 2:] += RESCUE_UID_BASE
    gd = walk_table.graph_to_device(G(g), "cpu")
    assert gd.h == (64 if k == 8 else 128)
    start, uid = torch.from_numpy(sub.start), torch.from_numpy(sub.uid)
    got = walk_scan.walk_scan(gd.wide, start, uid, seed, max_steps)
    ref_bits = np.array(ref._stable_bits_table(seed, jnp.asarray(sub.uid), max_steps))
    want = walk_scan.walk_scan_torch(gd.wide, start, torch.from_numpy(ref_bits.view(np.int32)),
                                     max_steps)
    assert torch.equal(got, want)
    core = ref._run_walks_mc_fast(ref.graph_to_device(g), ref.plan_to_device(sub), seed,
                                  n_anchors=g.n_anchors, max_steps=max_steps)
    resolved = engine.resolve_mc_events(
        interop.plan_dev_from_numpy(sub), *got, n_nodes=int(gd.wide.shape[0]),
        n_anchors=g.n_anchors, max_steps=max_steps)
    assert_walks_equal(core, resolved)
    assert_walks_equal(core, engine.run_walks_mc(gd, interop.plan_dev_from_numpy(sub), seed,
                                                 n_anchors=g.n_anchors, max_steps=max_steps))


def test_walk_scan_entry_rejects_what_the_kernel_does_not_take():
    wide = torch.zeros((8, 6 * 64), dtype=torch.int32)
    start = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="uid"):
        walk_scan.walk_scan(wide, start, torch.zeros(3, dtype=torch.int32), 0, 3)
    with pytest.raises(ValueError, match="uid"):
        walk_scan.walk_scan(wide, start, start.long(), 0, 3)
    with pytest.raises(ValueError, match="wide"):
        walk_scan.walk_scan(wide[:, :100], start, start, 0, 3)


@pytest.mark.parametrize("kind", ["greedy", "mixed"])
def test_kind_sections_match_reference(rng, kind):
    g = random_graph(rng)
    p = plan_walks(g, ScaffoldConfig(mc_walks_per_end=8, max_steps=10))
    if kind == "greedy":
        lo, hi = p.sections["greedy"]
        p = ref._slice_plan(p, lo, hi)
    want = ref._run_walks_kind(ref.graph_to_device(g), ref.plan_to_device(p), 5,
                               n_anchors=g.n_anchors, max_steps=10, kind=kind)
    got = engine.run_walks_kind(walk_table.graph_to_device(G(g), "cpu"),
                                engine.plan_to_device(P(p), "cpu"), 5,
                                n_anchors=g.n_anchors, max_steps=10, kind=kind)
    assert_walks_equal(want, got)


def test_chain_graph_semantics_match_reference():
    """Forced first edges (one invalid), greedy OS/ES and MC on the hand graph."""
    from test_walk import mk_plan

    g = chain_graph()
    p = mk_plan([0, 0, 0, 0, 0], [0, 1, -1, -1, -1],
                [MODE_GREEDY_ES, MODE_GREEDY_ES, MODE_GREEDY_OS, MODE_GREEDY_ES, MODE_MC])
    p.active[3] = False
    want = ref.run_walks(ref.graph_to_device(g), ref.plan_to_device(p), 0,
                         n_anchors=g.n_anchors, max_steps=8)
    got = engine.run_walks(walk_table.graph_to_device(G(g), "cpu"),
                           engine.plan_to_device(P(p), "cpu"), 0,
                           n_anchors=g.n_anchors, max_steps=8)
    assert_walks_equal(want, got)


@pytest.mark.parametrize("max_batch", [8, 64, 1000])
def test_sectioned_and_chunked_match_run_walks_host(rng, max_batch):
    g = random_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=16, max_steps=10, max_walk_batch=max_batch)
    p = plan_walks(g, cfg)
    want = ref.run_walks_host(g, p, cfg)
    got = engine.run_walks_host(G(g), P(p), C(cfg), "cpu")
    assert_walks_equal(want, got)
    one = engine.run_walks_sectioned(walk_table.graph_to_device(G(g), "cpu"), P(p), cfg.mc_seed,
                                     n_anchors=g.n_anchors, max_steps=10)
    assert_walks_equal(want, one)


@pytest.mark.parametrize("mode", [MODE_GREEDY_OS, MODE_GREEDY_ES, MODE_MC])
def test_engine_matches_oracle(rng, mode):
    g = random_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=3, max_steps=10)
    plan = plan_walks(g, cfg)
    sel = np.flatnonzero(plan.active & (plan.mode == mode))[:40]
    r = engine.run_walks(walk_table.graph_to_device(G(g), "cpu"),
                         engine.plan_to_device(P(plan), "cpu"), 11,
                         n_anchors=g.n_anchors, max_steps=10).to_numpy()
    choice = jax_choice_fn(11, 10)
    for i in sel:
        o = walk_oracle(g, int(plan.start[i]), int(plan.first_edge[i]), mode,
                        int(plan.uid[i]), 10, choice)
        assert list(r.nodes[i][:o.steps + 1]) == o.nodes, f"walk {i}"
        assert (r.steps[i], bool(r.success[i]), r.terminal[i], r.path_len[i]) == \
            (o.steps, o.success, o.terminal, o.path_len)
        # the oracle sums in float64: float32 rounding differs by design
        assert r.score_sum[i] == pytest.approx(o.score_sum, rel=1e-6)


def _planted_records(rng, w=96, s=12, n_anchors=8, n_nodes=50_000):
    """The reference test's records with every event class planted."""
    nxts = rng.integers(2 * n_anchors, n_nodes, (w, s)).astype(np.int32)
    start = rng.integers(2 * n_anchors, n_nodes, w).astype(np.int32)
    nxts[0:16, 5] = start[0:16]                    # revisit the start
    nxts[16:32, 7] = nxts[16:32, 2]                # revisit an interior node
    totals = rng.integers(1, 5, (w, s)).astype(np.int32)
    totals[32:40, 4] = 0                           # dead row
    nxts[40:64, 3] = rng.integers(0, 2 * n_anchors, 24)   # anchor hit
    totals[56:64, 3] = 0                           # anchor + kill, same step
    eids = rng.integers(0, 1000, (w, s)).astype(np.int32)
    adv = rng.integers(0, 500, (w, s)).astype(np.int32)
    es = rng.uniform(0, 100, (w, s)).astype(np.float32)   # non-integral: order matters
    active = np.ones(w, bool)
    active[90:] = False
    return start, active, nxts, totals, eids, adv, es


@pytest.mark.parametrize("n_nodes", [50_000, 40_000_000])
def test_resolve_mc_events_both_branches(rng, n_nodes):
    """n_nodes 40M forces the pairwise revisit branch (mult = 64 at S = 12)."""
    s, n_anchors = 12, 8
    start, active, nxts, totals, eids, adv, es = _planted_records(rng)
    w = len(start)
    pd = ref.PlanDev(start=jnp.asarray(start), first_edge=jnp.full(w, -1, jnp.int32),
                     mode=jnp.full(w, MODE_MC, jnp.int32),
                     uid=jnp.arange(w, dtype=jnp.int32), active=jnp.asarray(active))
    recs = [nxts, totals, eids, adv, es.view(np.int32)]
    want = ref._resolve_mc_events(pd, *[jnp.asarray(a) for a in recs], n_nodes=n_nodes,
                                  n_anchors=n_anchors, max_steps=s)
    got = engine.resolve_mc_events(interop.plan_dev_from_numpy(pd),
                                   *[torch.from_numpy(a) for a in recs],
                                   n_nodes=n_nodes, n_anchors=n_anchors, max_steps=s)
    assert_walks_equal(want, got)
    for i, (nodes, _, n_taken, success, terminal, plen, _) in enumerate(
            _resolve_oracle(start, active, nxts, totals, eids, adv, es, n_anchors, s)):
        assert got.nodes[i].tolist() == nodes and int(got.steps[i]) == n_taken, i
        assert (bool(got.success[i]), int(got.terminal[i]), int(got.path_len[i])) == \
            (success, terminal, plen), i


def test_empty_plan_gives_empty_records():
    from test_walk import mk_graph

    g = mk_graph(6, 2, 2, {4: [(5, 1.0, 1.0, 10)]})   # anchors have no out-edges
    p = plan_walks(g, ScaffoldConfig(mc_walks_per_end=4))
    got = engine.run_walks_host(G(g), P(p), C(ScaffoldConfig(max_steps=8)), "cpu")
    assert tuple(got.nodes.shape) == (0, 9) and got.score_sum.dtype == torch.float32


@pytest.mark.parametrize("w", [1, 7, 1024])
def test_sum_steps_matches_xla_row_sum(w):
    """_sum_steps is bit-equal to the reference's jnp.sum(axis=1) for every
    S in 1..160: sequential up to 32 steps, XLA's padded 32-wide windows above.
    One jit holds the 160 row sums (XLA rewrites each reduce on its own), so
    the module compiles once per W."""
    rng = np.random.default_rng(w)
    xs = []
    for s in range(1, 161):
        x = (rng.standard_normal((w, s)) * rng.uniform(0.1, 100, (w, s))).astype(np.float32)
        x[rng.random((w, s)) < 0.3] = 0.0   # steps not taken
        xs.append(x)
    row_sums = jax.jit(lambda arrays: [jnp.sum(a, axis=1) for a in arrays])(xs)
    for x, want in zip(xs, row_sums):
        got = walk_common.sum_steps(torch.from_numpy(x)).numpy().view(np.int32)
        np.testing.assert_array_equal(got, np.asarray(want).view(np.int32),
                                      err_msg=f"S={x.shape[1]}")


def _long_walk_graph(rng, n_seqs=600, n_anchors=4, k=4):
    """Every node has 2..k out-edges and anchors are rare, so most walks run
    past 32 steps (random_graph's dead rows end them within a few)."""
    rows = {}
    for u in range(2 * n_seqs):
        dsts = rng.choice(2 * n_seqs, size=int(rng.integers(2, k + 1)), replace=False)
        rows[u] = [(int(d), float(np.float32(rng.uniform(0.1, 50))),
                    float(np.float32(rng.uniform(0.1, 50))), int(rng.integers(1, 500)))
                   for d in dsts]
    return mk_graph(2 * n_seqs, n_anchors, k, rows)


@pytest.mark.parametrize("dispatch", ["mc", "greedy", "mixed", "chunked"])
@pytest.mark.parametrize("max_steps", [48, 64, 96])
def test_engines_match_reference_above_32_steps(rng, max_steps, dispatch):
    g = _long_walk_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=16, max_steps=max_steps, max_walk_batch=64)
    p = plan_walks(g, cfg)
    if dispatch == "chunked":
        want = ref.run_walks_host(g, p, cfg)
        got = engine.run_walks_host(G(g), P(p), C(cfg), "cpu")
    else:
        if dispatch != "mixed":
            lo, hi = p.sections[dispatch]
            p = ref._slice_plan(p, lo, hi)
        gd, pd = ref.graph_to_device(g), ref.plan_to_device(p)
        kw = dict(n_anchors=g.n_anchors, max_steps=max_steps)
        want = (ref._run_walks_mc_fast(gd, pd, cfg.mc_seed, **kw) if dispatch == "mc"
                else ref._run_walks_kind(gd, pd, cfg.mc_seed, **kw, kind=dispatch))
        got = engine.run_walks_kind(walk_table.graph_to_device(G(g), "cpu"),
                                    engine.plan_to_device(P(p), "cpu"), cfg.mc_seed, **kw,
                                    kind=dispatch)
    assert (np.asarray(want.steps) > 32).any()   # the windowed order is exercised
    assert_walks_equal(want, got)

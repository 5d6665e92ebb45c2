"""The port's consensus against the reference: path signatures bit for bit, and
group_and_select / compress equal to the reference and to its scalar oracle on
random summaries, in both grouping modes and both support modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telomeri_tpu.consensus import grouping as ref
from telomeri_tpu_torch.consensus import grouping


def random_walks(rng, n=600, s=10, n_anchors=4, virtual_base=60):
    """Walk records whose interiors repeat often (so distinct-path counting and
    exact score ties both occur), with hop nodes >= virtual_base mixed in."""
    start = rng.integers(0, 2 * n_anchors, n).astype(np.int32)
    terminal = rng.integers(0, 2 * n_anchors, n).astype(np.int32)
    steps = rng.integers(1, s + 1, n).astype(np.int32)
    pool = rng.integers(2 * n_anchors, virtual_base + 6, (12, s + 1)).astype(np.int32)
    nodes = pool[rng.integers(0, len(pool), n)].copy()
    nodes[:, 0] = start
    col = np.arange(s + 1)[None, :]
    nodes[col > steps[:, None]] = -1
    nodes[np.arange(n), steps] = terminal
    success = rng.random(n) < 0.75
    path_len = (rng.integers(0, 8, n) * 150 + rng.integers(0, 2, n) * 2000).astype(np.int32)
    score = rng.integers(1, 30, n).astype(np.float32) * np.float32(0.37)
    return dict(nodes=nodes, steps=steps, start=start, terminal=terminal,
                success=success, path_len=path_len, score_sum=score,
                uid=rng.permutation(n).astype(np.int32)), virtual_base


def _ref_summary(d, vb):
    sig = ref.path_signature(jnp.asarray(d["nodes"]), jnp.asarray(d["steps"]),
                             jnp.asarray(vb, jnp.int32))
    return ref.WalkSummary(
        start=jnp.asarray(d["start"]), terminal=jnp.asarray(d["terminal"]),
        success=jnp.asarray(d["success"]), path_len=jnp.asarray(d["path_len"]),
        score_sum=jnp.asarray(d["score_sum"]), uid=jnp.asarray(d["uid"]), sig=sig)


def _port_summary(d, vb):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    return grouping.WalkSummary(
        start=t["start"], terminal=t["terminal"], success=t["success"],
        path_len=t["path_len"], score_sum=t["score_sum"], uid=t["uid"],
        sig=grouping.path_signature(t["nodes"], t["steps"], vb))


def test_path_signature_bitwise(rng):
    d, vb = random_walks(rng)
    want = np.asarray(ref.path_signature(jnp.asarray(d["nodes"]), jnp.asarray(d["steps"]),
                                         jnp.asarray(vb, jnp.int32)))
    got = grouping.path_signature(torch.from_numpy(d["nodes"]),
                                  torch.from_numpy(d["steps"]), vb)
    assert got.dtype == torch.int64 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("support", ["walk_count", "read_diverse"])
@pytest.mark.parametrize("grouping_mode", ["windowed", "fixed"])
def test_group_and_select_matches_reference_and_oracle(rng, grouping_mode, support):
    d, vb = random_walks(rng)
    kw = dict(n_anchors=4, group_window=250, min_support=2, grouping=grouping_mode,
              support=support)
    want = ref.group_and_select(_ref_summary(d, vb), **kw).to_numpy()
    got = grouping.group_and_select(_port_summary(d, vb), **kw).to_numpy()
    # every field on every row, padding rows included (segment identities)
    for f, a, b in zip(want._fields, want, got):
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        if f == "rep_score":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f)
    rows = grouping.compress(got)
    assert rows == ref.compress(want) and rows
    okw = dict(n_anchors=4, group_window=250, min_support=2, grouping=grouping_mode,
               support=support, nodes=d["nodes"], steps=d["steps"], virtual_base=vb)
    # the port's consensus against the port's own oracle, and that oracle
    # against the reference's on the same summaries
    oracle = grouping.consensus_oracle(_port_summary(d, vb), **okw)
    assert rows == oracle
    assert oracle == ref.consensus_oracle(_ref_summary(d, vb), **okw)


def test_oracle_interior_key_matches_reference(rng):
    d, vb = random_walks(rng)
    for row, steps in zip(d["nodes"], d["steps"]):
        assert (grouping.oracle_interior_key(row, int(steps), vb)
                == ref.oracle_interior_key(row, int(steps), vb))


def test_oracle_needs_records_for_read_diverse(rng):
    d, vb = random_walks(rng, n=20)
    with pytest.raises(ValueError, match="nodes/steps/virtual_base"):
        grouping.consensus_oracle(_port_summary(d, vb), 4, 250, 2, support="read_diverse")


def test_empty_and_all_failed_summaries(rng):
    d, vb = random_walks(rng, n=20)
    d["success"][:] = False
    kw = dict(group_window=100, min_support=1, support="read_diverse")
    assert grouping.compress(grouping.group_and_select(_port_summary(d, vb), **kw)) == []
    empty = {k: v[:0] for k, v in d.items()}
    c = grouping.group_and_select(_port_summary(empty, vb), **kw)
    assert c.valid.shape == (0,) and c.win_distinct.shape == (0,)


@pytest.mark.parametrize("support", ["walk_count", "read_diverse"])
def test_consensus_of_a_chunked_plan_is_unchanged(toy_dataset_dir, support):
    """A plan above max_walk_batch rows comes back from run_walks_host as host
    records, and the consensus summarizes them chunk by chunk (the device then
    holds one chunk's records): every field of the ConsensusResult equals the
    unchunked run's, and the summary equals summarize over all records."""
    import dataclasses
    import os

    from telomeri_tpu_torch.config import ScaffoldConfig
    from telomeri_tpu_torch.pipeline import _consensus, build_graph, load_inputs
    from telomeri_tpu_torch.walk.engine import run_walks_host
    from telomeri_tpu_torch.walk.plan import plan_walks

    inputs = [os.path.join(toy_dataset_dir, f)
              for f in ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")]
    cfg = ScaffoldConfig(mc_walks_per_end=24, max_steps=16, support_mode=support)
    _, graph = build_graph(*load_inputs(*inputs), cfg, device="cpu")
    plan = plan_walks(graph, cfg)
    chunked_cfg = dataclasses.replace(cfg, max_walk_batch=50)
    assert len(plan) > 3 * 50 and len(plan) % 50   # several chunks and a ragged tail
    whole = run_walks_host(graph, plan, cfg, "cpu")
    parts = run_walks_host(graph, plan, chunked_cfg, "cpu")
    want = _consensus(whole, plan, graph, cfg, "cpu")
    for walks in (parts, parts.to_numpy()):   # host tensors, and an artifact's numpy records
        got = _consensus(walks, plan, graph, chunked_cfg, "cpu")
        for f, a, b in zip(want._fields, want, got):
            if a is None:
                assert b is None, f
                continue
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert grouping.compress(want)
    uid = torch.from_numpy(plan.uid)
    one = grouping.summarize(whole, uid, graph.virtual_base)
    many = grouping.summarize_in_chunks(parts, uid, graph.virtual_base, 50, "cpu")
    for f, a, b in zip(one._fields, one, many):
        assert torch.equal(a, b), f
    assert grouping.summarize_in_chunks(parts, uid, None, 50, "cpu").sig is None

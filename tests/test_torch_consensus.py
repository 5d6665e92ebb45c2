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
    oracle = ref.consensus_oracle(
        _ref_summary(d, vb), n_anchors=4, group_window=250, min_support=2,
        grouping=grouping_mode, support=support, nodes=d["nodes"], steps=d["steps"],
        virtual_base=vb)
    assert rows == oracle


def test_empty_and_all_failed_summaries(rng):
    d, vb = random_walks(rng, n=20)
    d["success"][:] = False
    kw = dict(group_window=100, min_support=1, support="read_diverse")
    assert grouping.compress(grouping.group_and_select(_port_summary(d, vb), **kw)) == []
    empty = {k: v[:0] for k, v in d.items()}
    c = grouping.group_and_select(_port_summary(empty, vb), **kw)
    assert c.valid.shape == (0,) and c.win_distinct.shape == (0,)

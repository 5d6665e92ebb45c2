"""The port's scalar walk oracle: torch_choice_fn draws the reference's
jax_choice_fn decisions bit for bit (rescue uids >= 2**30 included), and the
port's engine equals walk_oracle driven by torch_choice_fn in all three walk
modes, with no jax in the loop."""

import dataclasses

import numpy as np
import pytest
from test_walk import random_graph

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.walk import oracle as ref_oracle
from telomeri_tpu.walk.plan import MODE_GREEDY_ES, MODE_GREEDY_OS, MODE_MC, plan_walks
from telomeri_tpu_torch import interop
from telomeri_tpu_torch.walk import engine
from telomeri_tpu_torch.walk.oracle import (
    OracleWalk,
    fast_choice_fn,
    torch_choice_fn,
    walk_oracle,
)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_torch_choice_fn_equals_jax_choice_fn(rng, seed):
    s_max = 24
    want, got = ref_oracle.jax_choice_fn(seed, s_max), torch_choice_fn(seed, s_max)
    uids = np.concatenate([rng.integers(0, 2**20, 12), (1 << 30) + rng.integers(0, 2**24, 6),
                           [0, 2**31 - 1]])
    for uid in uids:
        for step in rng.integers(0, s_max, 6):
            k = int(rng.integers(1, 40))
            cum = np.cumsum(rng.integers(0, 3000, k)).astype(np.int32)
            if rng.random() < 0.1:
                cum[:] = 0                      # dead row: -1 from both
            assert got(int(uid), int(step), cum) == want(int(uid), int(step), cum), \
                (uid, step)


@pytest.mark.parametrize("mode", [MODE_GREEDY_OS, MODE_GREEDY_ES, MODE_MC])
def test_engine_matches_torch_oracle(rng, mode):
    g = random_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=3, max_steps=10)
    plan = plan_walks(g, cfg)
    sel = np.flatnonzero(plan.active & (plan.mode == mode))[:40]
    assert len(sel)
    g_port = interop.graph_from_reference(g)
    r = engine.run_walks(engine.graph_to_device(g_port, "cpu"),
                         engine.plan_to_device(interop.plan_from_reference(plan), "cpu"),
                         11, n_anchors=g.n_anchors, max_steps=10).to_numpy()
    choice = torch_choice_fn(11, 10)
    for i in sel:
        o = walk_oracle(g_port, int(plan.start[i]), int(plan.first_edge[i]), mode,
                        int(plan.uid[i]), 10, choice)
        assert isinstance(o, OracleWalk)
        assert list(r.nodes[i][:o.steps + 1]) == o.nodes, f"walk {i}"
        assert list(r.eids[i][:o.steps]) == o.eids
        assert (r.steps[i], bool(r.success[i]), r.terminal[i], r.path_len[i]) == \
            (o.steps, o.success, o.terminal, o.path_len)
        # both sum float32 in step order from 0.0: the same bits
        assert np.float32(r.score_sum[i]) == np.float32(o.score_sum)


def test_oracle_without_cumw_matches_reference(rng):
    """The cumw-less branch derives the weights with the port's mc_weights."""
    g = dataclasses.replace(random_graph(rng), cumw=None)
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=4, max_steps=10))
    for i in np.flatnonzero(plan.active & (plan.mode == MODE_MC))[:20]:
        args = (int(plan.start[i]), -1, MODE_MC, int(plan.uid[i]), 10)
        got = walk_oracle(interop.graph_from_reference(g), *args, torch_choice_fn(3, 10))
        want = ref_oracle.walk_oracle(g, *args, ref_oracle.jax_choice_fn(3, 10))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    fast = walk_oracle(interop.graph_from_reference(g), int(plan.start[0]), -1, MODE_MC, 0, 10, fast_choice_fn(3))
    assert fast.steps <= 10 and fast.nodes[0] == int(plan.start[0])

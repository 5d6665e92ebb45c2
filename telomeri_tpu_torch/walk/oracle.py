"""Scalar single-walk oracle: the port of telomeri_tpu/walk/oracle.py.

walk_oracle runs one walk in plain Python over the tensorized rows, with every
Monte-Carlo decision delegated to a choice_fn(uid, step, cum_row) -> slot.
torch_choice_fn draws from this package's Threefry stream
(walk/engine.py stable_bits_table), so the engine must match the oracle
decision for decision; the reference's jax_choice_fn draws the same bits from
jax. The walk itself, OracleWalk and fast_choice_fn (a cheap Python RNG for
baseline timing) are the reference's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.walk import oracle as _ref
from telomeri_tpu.walk.oracle import OracleWalk, fast_choice_fn  # noqa: F401  (re-exported)
from telomeri_tpu_torch.walk.engine import mc_weights, stable_bits_table


def torch_choice_fn(seed: int, max_steps: int):
    """Per-(uid, step) sampler on the engine's stream and integer inverse-CDF:
    step s of walk uid draws stable_bits_table(seed, [uid], max_steps)[s], and
    picks the first slot with cum > (bits & 0x7FFFFFFF) % total (-1 for a dead
    row). Receives the row's precomputed weight cumsum (GraphTensors.cumw)."""
    cache: dict[int, np.ndarray] = {}

    def fn(uid: int, step: int, cum_row: np.ndarray) -> int:
        stream = cache.get(uid)
        if stream is None:
            stream = cache[uid] = stable_bits_table(
                seed, torch.tensor([uid], dtype=torch.int32), max_steps)[:, 0].numpy()
        total = int(cum_row[-1])
        if total <= 0:
            return -1
        r = (int(stream[step]) & 0x7FFFFFFF) % total
        return int(np.argmax(cum_row > r))

    return fn


def walk_oracle(
    g: GraphTensors,
    start: int,
    first_edge: int,
    mode: int,
    uid: int,
    max_steps: int,
    choice_fn,
) -> OracleWalk:
    """The reference's walk_oracle. A graph without cumw gets it here from the
    port's mc_weights: the reference derives it through its jax engine."""
    if g.cumw is None:
        g = dataclasses.replace(
            g, cumw=np.cumsum(mc_weights(g.es), axis=1, dtype=np.int64))
    return _ref.walk_oracle(g, start, first_edge, mode, uid, max_steps, choice_fn)

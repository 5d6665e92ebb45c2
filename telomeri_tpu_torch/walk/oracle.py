"""Scalar single-walk oracle: the port of telomeri_tpu/walk/oracle.py.

walk_oracle runs one walk in plain Python over the tensorized rows (hierarchical
virtual nodes included), with every Monte-Carlo decision delegated to a
choice_fn(uid, step, cum_row) -> slot. torch_choice_fn draws from this package's
Threefry stream (walk/engine.py stable_bits_table), so the engine must match
the oracle decision for decision; the reference's jax_choice_fn draws the same
bits from jax and has no copy here. fast_choice_fn is a cheap Python RNG for
baseline timing (its decisions need not match the engine).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.walk.engine import mc_weights, stable_bits_table
from telomeri_tpu_torch.walk.plan import MODE_GREEDY_OS, MODE_MC


@dataclass
class OracleWalk:
    nodes: list[int]
    eids: list[int]
    steps: int
    success: bool
    terminal: int
    path_len: int
    score_sum: float


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


def fast_choice_fn(seed: int):
    """Cheap python RNG for baseline benchmarking (decisions need not match the
    engine). Does the same O(K) per-step sampling work over the row cumsum."""
    rngs: dict[int, random.Random] = {}

    def fn(uid: int, step: int, cum_row: np.ndarray) -> int:
        r = rngs.get(uid)
        if r is None:
            r = rngs[uid] = random.Random((seed << 32) ^ uid)
        total = int(cum_row[-1])
        if total <= 0:
            return -1  # dead end (no positive-weight candidate) — like the engine
        x = r.random() * total
        for j, v in enumerate(cum_row):
            if v > x:
                return j
        return len(cum_row) - 1

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
    """One walk, scalar semantics identical to run_walks (see engine docstring).

    The oracle traverses the TENSORIZED rows (including hierarchical virtual
    nodes), so hub semantics match the engine bit-for-bit by construction."""
    anchor_lim = 2 * g.n_anchors
    nbr, es, osb, adv, eid = g.nbr, g.es, g.os_, g.adv, g.eid
    if g.cumw is not None:
        cumw = g.cumw
    else:
        cumw = np.cumsum(mc_weights(es), axis=1, dtype=np.int64)
    cur = start
    path = [start]
    eids: list[int] = []
    plen = 0
    score = np.float32(0.0)
    for s in range(max_steps):
        row_n = nbr[cur]
        row_os = osb[cur]
        k = len(row_n)
        valid = [row_n[j] >= 0 and int(row_n[j]) not in path for j in range(k)]

        if s == 0 and first_edge >= 0:
            choice = first_edge
            if not valid[choice]:
                break
        elif mode == MODE_MC:
            # sample the FULL static row distribution; revisits kill below
            choice = choice_fn(uid, s, np.asarray(cumw[cur]))
            if choice < 0:
                break
        elif mode == MODE_GREEDY_OS:
            best, choice = -np.inf, -1
            for j in range(k):
                if valid[j] and row_os[j] > best:
                    best, choice = float(row_os[j]), j
            if choice < 0:
                break
        else:
            # greedy-ES = FIRST valid slot: rows are ES-desc sorted at build time
            # (hierarchical child slots store es=0 but sit at the sorted tail, so
            # an argmax over STORED es would diverge from the engine — the engine
            # takes the first valid slot, and so must the oracle)
            choice = -1
            for j in range(k):
                if valid[j]:
                    choice = j
                    break
            if choice < 0:
                break

        nxt = int(nbr[cur][choice])
        if nxt < 0:
            break  # chosen slot is padding (defensive: no choice_fn should do this)
        if mode == MODE_MC and nxt in path:
            break  # MC cycle kill: sampled an already-visited destination
        plen += int(adv[cur][choice])
        score = np.float32(score + es[cur][choice])
        path.append(nxt)
        eids.append(int(eid[cur][choice]))
        if nxt < anchor_lim:
            return OracleWalk(path, eids, len(eids), True, nxt, plen, float(score))
        cur = nxt
    return OracleWalk(path, eids, len(eids), False, -1, plen, float(score))

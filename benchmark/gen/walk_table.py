"""A random walk table and an all-Monte-Carlo walk plan, made on the device.

The table follows the distributions of the reference bench's hg002-graph
generator (`bench_hg002_graph`): N oriented nodes with K out-slots each, the
degree uniform on [deg_min, K], neighbours uniform over the non-anchor nodes
[2 * n_anchors, N), ES uniform on [es_lo, es_hi) in float32 with OS = ES,
advances uniform on [adv_lo, adv_hi); slots past a node's degree hold the
pads (nbr and eid -1, the rest 0). It is packed as the program's walk table
is, one (N, 6H) int32 row per node:

    [nbr | cum | eid | adv | es_bits | os_bits],   H = 64, 128, ... >= K

cum is the running sum of the integer MC weights ceil(ES) (at least 1 where
ES > 0), its pads carrying the row total; the edge id of slot j of node v is
v * K + j. The draws come from one torch.Generator on the device seeded with
the run's seed, block by block of rows, so the temporaries stay small and the
same seed on the same device gives the same table.
"""

from __future__ import annotations

import torch

MODE_MC = 2


def lane_width(k: int) -> int:
    """The packed half-width H: the smallest of 64, 128, 256, ... >= k."""
    h = 64
    while h < k:
        h *= 2
    return h


def make_table(n: int, k: int, *, n_anchors: int, deg: tuple[int, int],
               es: tuple[float, float], adv: tuple[int, int], gen: torch.Generator,
               device, block: int = 1 << 19) -> torch.Tensor:
    """The (N, 6H) int32 table, filled a block of rows at a time."""
    if n * k >= 2**31:
        raise ValueError(f"edge ids of {n} x {k} slots do not fit int32")
    h = lane_width(k)
    wide = torch.empty((n, 6 * h), dtype=torch.int32, device=device)
    slot = torch.arange(k, device=device)[None, :]
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        b = hi - lo
        d = torch.randint(deg[0], deg[1] + 1, (b, 1), generator=gen, device=device)
        live = slot < d
        nbr = torch.randint(2 * n_anchors, n, (b, k), generator=gen, device=device,
                            dtype=torch.int32)
        es_v = torch.rand((b, k), generator=gen, device=device) * (es[1] - es[0]) + es[0]
        es_v = torch.where(live, es_v, 0.0)
        adv_v = torch.randint(adv[0], adv[1], (b, k), generator=gen, device=device,
                              dtype=torch.int32)
        weight = torch.where(es_v > 0, torch.clamp_min(torch.ceil(es_v), 1), 0).to(torch.int32)
        cum = torch.cumsum(weight, dim=1, dtype=torch.int32)
        eid = (torch.arange(lo, hi, device=device, dtype=torch.int64)[:, None] * k
               + slot).to(torch.int32)
        rows = wide[lo:hi]
        rows[:, 0:k] = torch.where(live, nbr, -1)
        rows[:, h:h + k] = cum
        rows[:, 2 * h:2 * h + k] = torch.where(live, eid, -1)
        rows[:, 3 * h:3 * h + k] = torch.where(live, adv_v, 0)
        rows[:, 4 * h:4 * h + k] = es_v.view(torch.int32)
        rows[:, 5 * h:5 * h + k] = es_v.view(torch.int32)
        if h > k:
            rows[:, k:h] = -1
            rows[:, h + k:2 * h] = cum[:, -1:]
            rows[:, 2 * h + k:3 * h] = -1
            for blk in (3, 4, 5):
                rows[:, blk * h + k:(blk + 1) * h] = 0
    return wide


def make_plan(w: int, *, n_anchors: int, gen: torch.Generator, device) -> dict:
    """W Monte-Carlo walks from anchor ends drawn uniformly on [0, 2 * n_anchors),
    uids 0..W-1, every walk active and free to pick its first edge."""
    return dict(start=torch.randint(0, 2 * n_anchors, (w,), generator=gen, device=device,
                                    dtype=torch.int32),
                first_edge=torch.full((w,), -1, dtype=torch.int32, device=device),
                mode=torch.full((w,), MODE_MC, dtype=torch.int32, device=device),
                uid=torch.arange(w, dtype=torch.int32, device=device),
                active=torch.ones(w, dtype=torch.bool, device=device))

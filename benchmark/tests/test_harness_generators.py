"""The benchmark's input generators: the frozen simulator against the
program's, and the walk-table generator's shapes, ranges and determinism."""

from __future__ import annotations

import dataclasses
import filecmp
import os

import numpy as np
import torch

from benchmark.gen import sim as frozen
from benchmark.gen import walk_table


def test_frozen_simulator_writes_the_programs_bytes(tmp_path):
    from telomeri_tpu_torch import sim as program

    params = dict(genome_len=120_000, repeat_len=1_500, n_repeat_copies=3, read_len_mean=2_500,
                  read_len_sd=400, coverage=12.0, error_rate=0.02, ins_rate=0.02,
                  del_rate=0.02, end_jitter=10, cross_copy_overlaps=True,
                  copy_divergence=0.02, seed=2**31 + 9)
    frozen.write_dataset(frozen.simulate(frozen.SimConfig(**params)), str(tmp_path / "a"))
    program.write_dataset(program.simulate(program.SimConfig(**params)), str(tmp_path / "b"))
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b")) and len(names) == 5
    for n in names:
        assert filecmp.cmp(tmp_path / "a" / n, tmp_path / "b" / n, shallow=False), n


def test_frozen_presets_are_the_programs():
    from telomeri_tpu_torch import sim as program

    assert {k: dataclasses.asdict(v) for k, v in frozen.PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in program.PRESETS.items()}


def _table(seed: int, n=3000, k=20):
    gen = torch.Generator().manual_seed(seed)
    return walk_table.make_table(n, k, n_anchors=40, deg=(4, k), es=(100.0, 5000.0),
                                 adv=(100, 3000), gen=gen, device="cpu", block=1024)


def test_walk_table_shapes_ranges_and_pads():
    n, k = 3000, 20
    wide = _table(5, n, k)
    h = walk_table.lane_width(k)
    assert h == 64 and wide.shape == (n, 6 * h) and wide.dtype == torch.int32
    nbr, cum, eid, adv = (wide[:, b * h:(b + 1) * h] for b in range(4))
    es = wide[:, 4 * h:5 * h].contiguous().view(torch.float32)
    os_ = wide[:, 5 * h:6 * h].contiguous().view(torch.float32)
    live = nbr >= 0
    deg = live.sum(1)
    assert int(deg.min()) >= 4 and int(deg.max()) <= k
    # live slots come first, then pads
    assert bool((live == (torch.arange(h)[None, :] < deg[:, None])).all())
    assert int(nbr[live].min()) >= 80 and int(nbr[live].max()) < n
    assert float(es[live].min()) >= 100 and float(es[live].max()) < 5000
    assert bool((es == os_).all()) and bool((es[~live] == 0).all())
    assert int(adv[live].min()) >= 100 and int(adv[live].max()) < 3000
    assert bool((adv[~live] == 0).all())
    slot = torch.arange(h)[None, :].expand(n, h)
    assert bool((eid[live] == (torch.arange(n)[:, None] * k + slot)[live]).all())
    assert bool((eid[~live] == -1).all())
    weight = torch.where(es > 0, torch.clamp_min(torch.ceil(es), 1), 0).to(torch.int64)
    assert bool((cum == torch.cumsum(weight, 1)).all())   # pads carry the row total


def test_walk_table_and_plan_follow_the_seed():
    assert torch.equal(_table(11), _table(11))
    assert not torch.equal(_table(11), _table(12))
    plan = walk_table.make_plan(5000, n_anchors=40, gen=torch.Generator().manual_seed(3),
                                device="cpu")
    assert int(plan["start"].min()) >= 0 and int(plan["start"].max()) < 80
    assert torch.equal(plan["uid"], torch.arange(5000, dtype=torch.int32))
    assert bool((plan["first_edge"] == -1).all()) and bool(plan["active"].all())
    assert bool((plan["mode"] == walk_table.MODE_MC).all())
    again = walk_table.make_plan(5000, n_anchors=40, gen=torch.Generator().manual_seed(3),
                                 device="cpu")
    assert all(torch.equal(plan[k], again[k]) for k in plan)
    assert np.unique(plan["start"].numpy()).size == 80

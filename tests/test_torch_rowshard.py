"""The port's row-sharded walk tables (dist/rowshard.py) against the replicated
run: on gloo worlds of 1, 2 and 4 CPU processes (test_torch_dist.py's worker),
the records are bit-equal to one device and to the reference's
run_walks_rowsharded on a jax mesh of the same size, and the consensus, a
rescue round and the toy pipeline's FASTA equal the replicated results; a world
of 2 does the same at 48 steps, above XLA's 32-step sequential sum. Also
the dead-row padding, the ValueError without a mesh, indivisible plans, and
the auto placement with the device memory limit patched."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_dist import (
    CFG,
    COUNTERS,
    INPUTS,
    PIPE_CFG,
    RESCUE_CFG,
    assert_records_equal,
    load_rank,
    read_bytes,
    read_json,
    reference_args,
    run_world,
)

from telomeri_tpu_torch import pipeline as tpipe
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.consensus.grouping import compress
from telomeri_tpu_torch.dist.mesh import WalkMesh
from telomeri_tpu_torch.dist.rowshard import run_walks_rowsharded, shard_graph_rows
from telomeri_tpu_torch.kernels import walk_table
from telomeri_tpu_torch.walk import engine
from telomeri_tpu_torch.walk.plan import plan_walks

CPU = torch.device("cpu")
LONG_CFG = dict(CFG, max_steps=48)
LONG_RESCUE_CFG = dict(RESCUE_CFG, max_steps=48)


def fake_mesh(rank: int, size: int) -> WalkMesh:
    """A mesh for what runs before any collective (layout, padding, checks)."""
    return WalkMesh(group=None, rank=rank, size=size, local_rank=0, device=CPU)


@pytest.fixture(scope="module")
def toy_graph(toy_dataset_dir):
    cfg = ScaffoldConfig(**CFG)
    return tpipe.build_graph(*tpipe.load_inputs(
        *[os.path.join(toy_dataset_dir, f) for f in INPUTS]), cfg, device="cpu")[1]


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory, toy_dataset_dir):
    n = request.param
    return n, run_world(tmp_path_factory.mktemp("rowshard"), n, "rowshard",
                        toy_dataset_dir, {"toy": (toy_dataset_dir, PIPE_CFG)})


def test_rowsharded_records_equal_replicated_and_reference(world, toy_graph):
    from telomeri_tpu.dist.mesh import make_walk_mesh
    from telomeri_tpu.dist.rowshard import run_walks_rowsharded as ref_rowsharded

    n, out = world
    cfg = ScaffoldConfig(**CFG)
    plan = plan_walks(toy_graph, cfg, n_shards=n)
    one = engine.run_walks_host(toy_graph, plan, cfg, "cpu").to_numpy()
    ref_graph, ref_plan, _ = reference_args(toy_graph, plan, cfg)
    ref = ref_rowsharded(ref_graph, ref_plan, cfg.mc_seed, n_anchors=toy_graph.n_anchors,
                         max_steps=cfg.max_steps, mesh=make_walk_mesh(n)).to_numpy()
    for r in range(n):
        rec, _, _ = load_rank(out, r)
        assert_records_equal(one, rec)
        assert_records_equal(ref, rec)


def test_rowsharded_world_of_2_above_32_steps(tmp_path_factory):
    """At 48 steps, where score_sum takes XLA's windowed order (on the spanning
    reads of test_torch_scenarios.py, whose sums the order changes): the records
    of a row-sharded gloo world of 2 equal one device and the reference's
    rowsharded mesh of 2, and its rescue round equals one device's."""
    from test_torch_scenarios import SPANNING_SIM, write_sim

    from telomeri_tpu.dist.mesh import make_walk_mesh
    from telomeri_tpu.dist.rowshard import run_walks_rowsharded as ref_rowsharded
    from telomeri_tpu_torch.walk.rescue import run_rescue_round

    data = write_sim(tmp_path_factory, "spanning", SPANNING_SIM)
    cfg, rcfg = ScaffoldConfig(**LONG_CFG), ScaffoldConfig(**LONG_RESCUE_CFG)
    out = run_world(tmp_path_factory.mktemp("rowshard48"), 2, "rowshard", data, {},
                    cfg=LONG_CFG, rescue_cfg=LONG_RESCUE_CFG)
    graph = tpipe.build_graph(*tpipe.load_inputs(*[os.path.join(data, f) for f in INPUTS]),
                              cfg, device="cpu")[1]
    plan = plan_walks(graph, cfg, n_shards=2)
    one = engine.run_walks_host(graph, plan, cfg, "cpu").to_numpy()
    assert (one.steps > cfg.max_steps // 2).any()   # sums that span both windows
    ref_graph, ref_plan, _ = reference_args(graph, plan, cfg)
    ref = ref_rowsharded(ref_graph, ref_plan, cfg.mc_seed, n_anchors=graph.n_anchors,
                         max_steps=cfg.max_steps, mesh=make_walk_mesh(2)).to_numpy()
    new, paths, blocked = run_rescue_round(graph, rcfg, [], 0, device="cpu")
    for r in range(2):
        rec, _, _ = load_rank(out, r)
        assert_records_equal(one, rec)
        assert_records_equal(ref, rec)
        got = read_json(out, f"rescue_rank{r}.json")
        assert (got["new"], got["blocked"]) == (repr(new), sorted(map(repr, blocked)))
        assert got["paths"] == {str(u): [p.nodes, p.eids] for u, p in paths.items()}


def test_rowsharded_consensus_equals_replicated(world, toy_graph):
    from telomeri_tpu_torch.pipeline import _consensus

    n, out = world
    cfg = ScaffoldConfig(**CFG)
    plan = plan_walks(toy_graph, cfg, n_shards=n)
    want = _consensus(engine.run_walks_host(toy_graph, plan, cfg, "cpu"), plan,
                      toy_graph, cfg, "cpu")
    for r in range(n):
        _, cons, _ = load_rank(out, r)
        assert compress(cons) == compress(want) and compress(want)
        np.testing.assert_array_equal(cons.win_distinct, want.win_distinct)


def test_rowsharded_rescue_round_equals_single_device(world, toy_graph):
    from telomeri_tpu_torch.walk.rescue import run_rescue_round

    n, out = world
    new, paths, blocked = run_rescue_round(toy_graph, ScaffoldConfig(**RESCUE_CFG), [], 0,
                                           device="cpu")
    for r in range(n):
        got = read_json(out, f"rescue_rank{r}.json")
        assert (got["new"], got["blocked"]) == (repr(new), sorted(map(repr, blocked)))
        assert got["paths"] == {str(u): [p.nodes, p.eids] for u, p in paths.items()}


def test_rowsharded_pipeline_output_identical(world, toy_dataset_dir, tmp_path):
    n, out = world
    one = tpipe.run_pipeline(*[os.path.join(toy_dataset_dir, f) for f in INPUTS],
                             str(tmp_path / "one.fa"), ScaffoldConfig(**PIPE_CFG),
                             device="cpu")
    m = one.metrics.as_dict()["metrics"]
    for r in range(n):
        assert read_bytes(os.path.join(out, f"toy_rank{r}.fa")) == \
            read_bytes(str(tmp_path / "one.fa"))
        got = read_json(out, f"toy_rank{r}.json")
        assert {k: got.get(k) for k in COUNTERS} == {k: m.get(k) for k in COUNTERS}


@pytest.mark.parametrize("size", [3, 4, 7])
def test_row_padding_dead_rows(toy_graph, size):
    """The shards, end to end, are the packed table plus dead pad rows (none
    where the world divides the node count: 640 rows)."""
    n = toy_graph.nbr.shape[0]
    shards = [shard_graph_rows(toy_graph, fake_mesh(r, size)).wide.numpy()
              for r in range(size)]
    assert len({s.shape for s in shards}) == 1
    table = np.concatenate(shards)
    assert table.shape[0] == n + (-n % size)
    np.testing.assert_array_equal(table[:n], walk_table.graph_to_device(toy_graph, CPU).wide.numpy())
    h = table.shape[1] // 6
    pad = table[n:]
    assert (pad[:, :h] == -1).all() and (pad[:, 2 * h:3 * h] == -1).all()   # nbr, eid
    assert (pad[:, h:2 * h] == 0).all()          # zero CDF: total 0, a dead row


def test_rowshard_requires_mesh(toy_dataset_dir, tmp_path):
    cfg = ScaffoldConfig(**CFG, graph_placement="rowshard")
    with pytest.raises(ValueError, match="pass --mesh N"):
        tpipe.run_pipeline(*[os.path.join(toy_dataset_dir, f) for f in INPUTS],
                           str(tmp_path / "x.fa"), cfg, device="cpu")


def test_plan_not_divisible_raises(toy_graph):
    """Raised before any collective, on every rank alike."""
    cfg = ScaffoldConfig(**CFG)
    plan = plan_walks(toy_graph, cfg, n_shards=8)
    lo, hi = plan.sections["mc"]
    plan = dataclasses.replace(plan, sections={**plan.sections, "mc": (lo, hi - 1)})
    with pytest.raises(ValueError, match="not divisible"):
        run_walks_rowsharded(toy_graph, plan, cfg.mc_seed, max_steps=cfg.max_steps,
                             mesh=fake_mesh(0, 8))


def test_auto_placement_counts_the_pick_plane_on_a_card(toy_graph, monkeypatch):
    """On a card each replicated rank builds the MC kernel's pick plane beside
    the table (2/3 of it, N x H x 16 B): a table that fits the 75% budget alone
    but not with its plane is row-sharded there, and replicated on a CPU mesh,
    which builds no plane."""
    from telomeri_tpu_torch.utils.logging import Metrics

    table = walk_table.device_table_bytes(toy_graph)
    n, h = toy_graph.nbr.shape[0], walk_table.lane_width(toy_graph.nbr.shape[1])
    assert walk_table.device_walk_bytes(toy_graph, CPU) == table
    assert walk_table.device_walk_bytes(toy_graph, "cuda") == table + n * h * 16
    cfg = ScaffoldConfig(**CFG, graph_placement="auto")
    card = WalkMesh(group=None, rank=0, size=4, local_rank=0, device=torch.device("cuda"))
    both = table + n * h * 16
    resolve = lambda mesh: tpipe._resolve_placement(cfg, toy_graph, mesh,
                                                    Metrics()).graph_placement
    # the table alone fits, table and plane do not
    monkeypatch.setattr(tpipe, "_device_memory_limit", lambda device: int(table / 0.75) + 4)
    assert resolve(card) == "rowshard"
    assert resolve(fake_mesh(0, 4)) == "replicated"
    # both just fit, and just do not
    monkeypatch.setattr(tpipe, "_device_memory_limit", lambda device: int(both / 0.75) + 4)
    assert resolve(card) == "replicated"
    monkeypatch.setattr(tpipe, "_device_memory_limit", lambda device: int(both / 0.75) - 4)
    assert resolve(card) == "rowshard"


def test_auto_placement_resolution(toy_graph, monkeypatch):
    """"auto": replicated for a small graph; rowshard only when the table
    exceeds 75% of the device's memory AND the mesh has more than one device."""
    from telomeri_tpu_torch.utils.logging import Metrics

    cfg = ScaffoldConfig(**CFG, graph_placement="auto")
    mesh = fake_mesh(0, 8)
    m = Metrics()
    assert tpipe._resolve_placement(cfg, toy_graph, mesh, m).graph_placement == "replicated"
    assert m.values["graph_placement"] == "replicated"

    need = walk_table.device_table_bytes(toy_graph)
    monkeypatch.setattr(tpipe, "_device_memory_limit", lambda device: int(need / 0.75) - 4)
    m = Metrics()
    assert tpipe._resolve_placement(cfg, toy_graph, mesh, m).graph_placement == "rowshard"
    assert m.values["graph_placement"] == "rowshard"
    monkeypatch.setattr(tpipe, "_device_memory_limit", lambda device: int(need / 0.75) + 4)
    assert tpipe._resolve_placement(cfg, toy_graph, mesh, Metrics()).graph_placement == \
        "replicated"

    # with no known limit, 16 GiB: a table that claims more flips to rowshard
    monkeypatch.setattr(tpipe, "_device_memory_limit", lambda device: None)
    monkeypatch.setattr(walk_table, "device_table_bytes", lambda g: 13 * 2**30)
    assert tpipe._resolve_placement(cfg, toy_graph, mesh, Metrics()).graph_placement == \
        "rowshard"
    # ... but not without a multi-device mesh
    for one in (fake_mesh(0, 1), None):
        assert tpipe._resolve_placement(cfg, toy_graph, one, Metrics()).graph_placement == \
            "replicated"
    # explicit placements pass through untouched
    for v in ("replicated", "rowshard"):
        explicit = dataclasses.replace(cfg, graph_placement=v)
        assert tpipe._resolve_placement(explicit, toy_graph, mesh,
                                        Metrics()).graph_placement == v

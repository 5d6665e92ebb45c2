"""The port's walks sharded over gloo worlds of 1, 2 and 4 CPU processes with a
replicated graph, against one device and against the reference's
run_walks_distributed on a jax mesh of the same size (conftest's 8 virtual CPU
devices): walk records bit for bit, the consensus, a rescue round, and the toy
pipeline's FASTA and counters. On a chimeric dataset where the cut-read gate
fires, every rank writes the bytes one process writes.

Worker processes start with subprocess.Popen and meet through a file:// store
under tmp_path (no TCP port for parallel test workers to fight over); each
runs the port alone, without jax. test_torch_rowshard.py drives the same
worker with the row-sharded placement."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from telomeri_tpu.config import ScaffoldConfig as RefConfig
from telomeri_tpu.graph.tensorize import GraphTensors as RefGraph
from telomeri_tpu.walk.plan import WalkPlan as RefPlan
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.consensus.grouping import ConsensusResult, compress
from telomeri_tpu_torch.dist import mesh as tmesh
from telomeri_tpu_torch.walk.engine import WalkResult
from telomeri_tpu_torch.walk.plan import plan_walks

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
CFG = dict(mc_walks_per_end=40, max_steps=16)
RESCUE_CFG = dict(max_steps=32, rescue_walks_per_end=300)
PIPE_CFG = dict(mc_walks_per_end=50, max_steps=32, rescue_walks_per_end=200)
GATE_CFG = dict(mc_walks_per_end=64, max_steps=16)
COUNTERS = ("n_walks", "n_walks_successful", "n_walks_truncated", "n_bridges_candidate",
            "n_bridges_accepted", "n_bridges_rescued", "n_bridges_cut_refused",
            "n_ends_blocked", "n_scaffolds")

WORKER = r"""
import json, os, sys
rank, world, store, spec = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from telomeri_tpu_torch.dist.mesh import (fetch_walk_rows, init_distributed, make_walk_mesh,
                                          run_walks_distributed, shutdown_distributed)
from telomeri_tpu_torch.pipeline import ScaffoldConfig, build_graph, load_inputs, run_pipeline
from telomeri_tpu_torch.walk.plan import plan_walks
from telomeri_tpu_torch.walk.rescue import run_rescue_round

init_distributed("cpu", init_method="file://" + store, rank=rank, world_size=world)
mesh = make_walk_mesh(world, "cpu")
out, pl = spec["out"], spec["placement"]
inputs = lambda d: [os.path.join(d, f) for f in spec["inputs"]]
cfg = ScaffoldConfig(**spec["cfg"], graph_placement=pl)
_, graph = build_graph(*load_inputs(*inputs(spec["toy"])), cfg, device="cpu")
plan = plan_walks(graph, cfg, n_shards=world)
walks, cons = run_walks_distributed(graph, plan, cfg, mesh)
rec = fetch_walk_rows(walks, np.arange(len(plan)), mesh)
np.savez(f"{out}/walks_rank{rank}.npz", rows=walks.rows, **rec._asdict(),
         **{"cons_" + k: v for k, v in cons._asdict().items() if v is not None})
rcfg = ScaffoldConfig(**spec["rescue_cfg"], graph_placement=pl)
new, paths, blocked = run_rescue_round(graph, rcfg, [], 0, mesh=mesh, placement=pl)
with open(f"{out}/rescue_rank{rank}.json", "w") as f:
    json.dump(dict(new=repr(new), blocked=sorted(map(repr, blocked)),
                   paths={str(u): [p.nodes, p.eids] for u, p in paths.items()}), f)
for name, (d, c) in spec["pipelines"].items():   # "auto" resolves to replicated here
    res = run_pipeline(*inputs(d), f"{out}/{name}_rank{rank}.fa", ScaffoldConfig(
        **c, graph_placement="auto" if pl == "replicated" else pl), mesh=mesh)
    with open(f"{out}/{name}_rank{rank}.json", "w") as f:
        json.dump(res.metrics.as_dict()["metrics"], f)
torch.distributed.barrier()   # the ranks leave together: no peer's sockets close under another
shutdown_distributed()
print("WORKER_OK", flush=True)
"""


def run_world(tmp_path, world: int, placement: str, toy_dir: str, pipelines: dict,
              cfg: dict = CFG, rescue_cfg: dict = RESCUE_CFG) -> str:
    """Run WORKER on a gloo world of `world` processes (walks under cfg, a rescue
    round under rescue_cfg, then the pipelines); returns its output dir."""
    out = tmp_path / f"{placement}_w{world}"
    out.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    spec = json.dumps(dict(out=str(out), placement=placement, toy=toy_dir, inputs=INPUTS,
                           cfg=cfg, rescue_cfg=rescue_cfg, pipelines=pipelines))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    store = str(tmp_path / f"store_{placement}_w{world}")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), store, spec],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in text, text[-3000:]
    return str(out)


def load_rank(out: str, rank: int):
    """(records, consensus, plan rows held) of one rank's walk run."""
    z = np.load(os.path.join(out, f"walks_rank{rank}.npz"))
    rec = WalkResult(*[z[f] for f in WalkResult._fields])
    cons = ConsensusResult(*[z["cons_" + f] if "cons_" + f in z else None
                             for f in ConsensusResult._fields])
    return rec, cons, z["rows"]


def read_json(out: str, name: str):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def to_reference(cls, obj):
    """The port's dataclass `obj` as the reference's class of the same fields."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def reference_args(graph, plan, cfg):
    return to_reference(RefGraph, graph), to_reference(RefPlan, plan), to_reference(RefConfig, cfg)


def assert_records_equal(want, got):
    """Every field equal; score_sum by its float32 bits."""
    for f in WalkResult._fields:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "score_sum":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def toy_graph(toy_dataset_dir):
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs

    cfg = ScaffoldConfig(**CFG)
    return build_graph(*load_inputs(*[os.path.join(toy_dataset_dir, f) for f in INPUTS]),
                       cfg, device="cpu")[1]


@pytest.fixture(scope="module")
def gate_dataset(tmp_path_factory):
    """The reference test's chimeric dataset: the cut-read gate fires on it."""
    from telomeri_tpu.sim import SimConfig, simulate, write_dataset

    d = str(tmp_path_factory.mktemp("gate_data"))
    write_dataset(simulate(SimConfig(
        genome_len=200_000, repeat_len=4_000, n_repeat_copies=4,
        read_len_mean=3_000, read_len_sd=500, coverage=15.0,
        error_rate=0.02, chimera_rate=0.2,
        dropout_len=10_000, dropout_starts=(33_800,), seed=3)), d)
    return d


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory, toy_dataset_dir, gate_dataset):
    n = request.param
    pipelines = {"toy": (toy_dataset_dir, PIPE_CFG), "gate": (gate_dataset, GATE_CFG)}
    return n, run_world(tmp_path_factory.mktemp("dist"), n, "replicated",
                        toy_dataset_dir, pipelines)


def test_walk_records_equal_single_device_and_reference_mesh(world, toy_graph):
    from telomeri_tpu.dist.mesh import make_walk_mesh, run_walks_distributed
    from telomeri_tpu_torch.walk.engine import run_walks_host

    n, out = world
    cfg = ScaffoldConfig(**CFG)
    plan = plan_walks(toy_graph, cfg, n_shards=n)
    one = run_walks_host(toy_graph, plan, cfg, "cpu").to_numpy()
    ref, _ = run_walks_distributed(*reference_args(toy_graph, plan, cfg), make_walk_mesh(n))
    for r in range(n):
        rec, _, rows = load_rank(out, r)
        assert_records_equal(one, rec)
        assert_records_equal(ref.to_numpy(), rec)
        np.testing.assert_array_equal(rows, tmesh.shard_plan(plan, tmesh.WalkMesh(
            None, r, n, 0, torch.device("cpu")))[1])
    assert sorted(np.concatenate([load_rank(out, r)[2] for r in range(n)]).tolist()) == \
        list(range(len(plan)))


def test_consensus_equals_reference_mesh(world, toy_graph):
    from telomeri_tpu.consensus.grouping import compress as ref_compress
    from telomeri_tpu.dist.mesh import make_walk_mesh, run_walks_distributed

    n, out = world
    cfg = ScaffoldConfig(**CFG)
    plan = plan_walks(toy_graph, cfg, n_shards=n)
    _, ref = run_walks_distributed(*reference_args(toy_graph, plan, cfg), make_walk_mesh(n))
    want = ref_compress(ref)
    for r in range(n):
        _, cons, _ = load_rank(out, r)
        assert compress(cons) == want and want
        np.testing.assert_array_equal(cons.win_distinct, np.asarray(ref.win_distinct))


def test_rescue_round_equals_single_device(world, toy_graph):
    from telomeri_tpu_torch.walk.rescue import run_rescue_round

    n, out = world
    new, paths, blocked = run_rescue_round(toy_graph, ScaffoldConfig(**RESCUE_CFG), [], 0,
                                           device="cpu")
    assert len(new) >= 2
    for r in range(n):
        got = read_json(out, f"rescue_rank{r}.json")
        assert got["new"] == repr(new)
        assert got["blocked"] == sorted(map(repr, blocked))
        assert got["paths"] == {str(u): [p.nodes, p.eids] for u, p in paths.items()}


@pytest.fixture(scope="module")
def reference_toy_run(toy_dataset_dir, tmp_path_factory):
    from telomeri_tpu.pipeline import run_pipeline as ref_run_pipeline

    out = str(tmp_path_factory.mktemp("ref_toy") / "ref.fa")
    res = ref_run_pipeline(*[os.path.join(toy_dataset_dir, f) for f in INPUTS], out,
                           RefConfig(**PIPE_CFG))
    return read_bytes(out), res.metrics.as_dict()["metrics"]


def test_toy_pipeline_matches_reference(world, reference_toy_run):
    n, out = world
    fasta, metrics = reference_toy_run
    for r in range(n):
        assert read_bytes(os.path.join(out, f"toy_rank{r}.fa")) == fasta
        got = read_json(out, f"toy_rank{r}.json")
        assert {k: got.get(k) for k in COUNTERS} == {k: metrics.get(k) for k in COUNTERS}
        assert got["graph_placement"] == "replicated"   # "auto" on a small graph


def test_gate_dataset_ranks_equal_one_process(world, gate_dataset, tmp_path):
    from telomeri_tpu_torch.pipeline import run_pipeline

    n, out = world
    res = run_pipeline(*[os.path.join(gate_dataset, f) for f in INPUTS],
                       str(tmp_path / "one.fa"), ScaffoldConfig(**GATE_CFG), device="cpu")
    m = res.metrics.as_dict()["metrics"]
    assert m["n_bridges_cut_refused"] > 0 and m["n_ends_blocked"] > 0   # the gate fired
    one = read_bytes(str(tmp_path / "one.fa"))
    for r in range(n):
        assert read_bytes(os.path.join(out, f"gate_rank{r}.fa")) == one
        got = read_json(out, f"gate_rank{r}.json")
        assert {k: got.get(k) for k in COUNTERS} == {k: m.get(k) for k in COUNTERS}


def test_plan_sections_must_divide_the_world(toy_graph):
    """The divisibility errors of the reference (mesh.py:79-82, 121-133)."""
    cfg = ScaffoldConfig(**CFG)
    fake = tmesh.WalkMesh(None, 0, 8, 0, torch.device("cpu"))
    plan = plan_walks(toy_graph, cfg, n_shards=8)
    local, rows = tmesh.shard_plan(plan, fake)
    assert len(local) * 8 == len(plan) and len(rows) == len(local)
    lo, hi = plan.sections["mc"]
    short = dataclasses.replace(plan, sections={**plan.sections, "mc": (lo, hi - 1)})
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        tmesh.shard_plan(short, fake)
    with pytest.raises(ValueError, match="walk batch"):
        tmesh.shard_plan(dataclasses.replace(plan, start=plan.start[:-1]), fake)


def test_world_of_one_without_launcher(monkeypatch):
    """No launcher: a world of 1 in this process; a larger mesh names torchrun."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    tmesh.init_distributed("cpu")
    try:
        m = tmesh.make_walk_mesh(1, "cpu")
        assert (m.rank, m.size, m.local_rank, m.device.type) == (0, 1, 0, "cpu")
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            tmesh.make_walk_mesh(2, "cpu")
    finally:
        tmesh.shutdown_distributed()
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_walk_mesh(1, "cpu")

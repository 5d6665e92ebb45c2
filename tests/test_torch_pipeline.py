"""The port's pipeline end to end, on CPU tensors: the lambda golden FASTA byte
for byte (library and CLI), the reference's FASTA and metric counters on the toy
simulation, and no jax anywhere in the port's import chain. The gpu-marked test
holds the CUDA kernels against their plain versions and runs only on a card."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from telomeri_tpu.config import ScaffoldConfig as RefConfig
from telomeri_tpu_torch import interop
from telomeri_tpu_torch.cli.main import main as cli_main
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.pipeline import run_pipeline

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
COUNTERS = ("n_walks", "n_walks_successful", "n_bridges_candidate",
            "n_bridges_accepted", "n_bridges_rescued", "n_scaffolds")


def _golden() -> bytes:
    with open(os.path.join(LAMBDA, "golden_scaffolds.fa"), "rb") as f:
        return f.read()


def _lambda_cfg(**kw) -> ScaffoldConfig:
    with open(os.path.join(LAMBDA, "config.json")) as f:
        cfg = json.loads(f.read())
    return ScaffoldConfig(**{**cfg, **kw})


@pytest.mark.parametrize("device_scoring", ["auto", "on"])
def test_lambda_golden_on_cpu(tmp_path, device_scoring):
    out = str(tmp_path / "scaffolds.fa")
    res = run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], out,
                       _lambda_cfg(device_scoring=device_scoring), device="cpu")
    with open(out, "rb") as f:
        assert f.read() == _golden()
    backend = res.metrics.as_dict()["metrics"]["scoring_backend"]
    assert backend == ("torch" if device_scoring == "on" else "numpy")


def test_toy_simulation_matches_reference(tmp_path, toy_dataset_dir):
    from telomeri_tpu.pipeline import run_pipeline as ref_run_pipeline

    args = [os.path.join(toy_dataset_dir, f) for f in INPUTS]
    cfg = RefConfig(mc_walks_per_end=50, max_steps=32, rescue_walks_per_end=200)
    want = ref_run_pipeline(*args, str(tmp_path / "ref.fa"), cfg)
    got = run_pipeline(*args, str(tmp_path / "port.fa"), interop.config_from_reference(cfg),
                       device="cpu")
    with open(tmp_path / "ref.fa", "rb") as a, open(tmp_path / "port.fa", "rb") as b:
        assert a.read() == b.read()
    mw, mg = want.metrics.as_dict()["metrics"], got.metrics.as_dict()["metrics"]
    assert {k: mg[k] for k in COUNTERS} == {k: mw[k] for k in COUNTERS}
    assert got.bridges == want.bridges and mg["n_scaffolds"] >= 1


def test_rescue_round_matches_reference(toy_dataset_dir):
    """A rescue round over every contig end (nothing accepted yet): the same new
    bridges, stitch paths and blocked ends as the reference's round."""
    from telomeri_tpu.graph.tensorize import GraphTensors as RefGraph
    from telomeri_tpu.walk.rescue import run_rescue_round as ref_rescue
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs
    from telomeri_tpu_torch.walk.rescue import run_rescue_round

    cfg = ScaffoldConfig(max_steps=32, rescue_walks_per_end=300)
    contigs, reads, paf = load_inputs(*[os.path.join(toy_dataset_dir, f) for f in INPUTS])
    _, graph = build_graph(contigs, reads, paf, cfg, device="cpu")
    want = ref_rescue(RefGraph(**graph.__dict__), RefConfig(**cfg.__dict__), [], 0)
    got = run_rescue_round(graph, cfg, [], 0, device="cpu")
    # Bridge and End are dataclasses of either package: compare them field by field
    assert [dataclasses.asdict(b) for b in got[0]] == [dataclasses.asdict(b) for b in want[0]]
    assert len(got[0]) >= 2
    assert {dataclasses.astuple(e) for e in got[2]} == {dataclasses.astuple(e) for e in want[2]}
    assert {u: (p.nodes, p.eids) for u, p in got[1].items()} == \
        {u: (p.nodes, p.eids) for u, p in want[1].items()}


def test_cli_scaffold_cpu_reproduces_golden(tmp_path):
    out = str(tmp_path / "cli.fa")
    rc = cli_main(["scaffold", "--device", "cpu",
                   "--config", os.path.join(LAMBDA, "config.json"),
                   "--contigs", os.path.join(LAMBDA, "contigs.fa"),
                   "--reads", os.path.join(LAMBDA, "reads.fa"),
                   "--paf-read-contig", os.path.join(LAMBDA, "read2contig.paf"),
                   "--paf-read-read", os.path.join(LAMBDA, "read2read.paf"),
                   "--out", out])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.read() == _golden()
    with open(out + ".metrics.json") as f:
        assert json.load(f)["metrics"]["device"] == "cpu"


@pytest.mark.parametrize("mesh", [0, 1], ids=["one_device", "mesh_of_1"])
def test_metrics_json_has_the_reference_dispatch_records(tmp_path, monkeypatch, mesh):
    """The CLI's metrics.json carries "dispatches" under the reference's keys
    (score, walk and rescue dispatches; ":D1" on a mesh of 1), one record each."""
    from telomeri_tpu.dist.mesh import make_walk_mesh
    from telomeri_tpu.pipeline import run_pipeline as ref_run_pipeline
    from telomeri_tpu.utils import watchdog
    from telomeri_tpu_torch.utils import watchdog as port_watchdog

    history = tmp_path / "dispatch_history.json"
    for mod in (watchdog, port_watchdog):   # one file, written by either package
        monkeypatch.setattr(mod, "HISTORY_PATH", str(history))
    inputs = [os.path.join(LAMBDA, f) for f in INPUTS]
    out = str(tmp_path / "port.fa")
    args = ["scaffold", "--device", "cpu", "--device-scoring", "on", "--out", out,
            "--config", os.path.join(LAMBDA, "config.json")]
    for flag, path in zip(("--contigs", "--reads", "--paf-read-contig", "--paf-read-read"),
                          inputs):
        args += [flag, path]
    assert cli_main(args + (["--mesh", "1"] if mesh else [])) == 0
    with open(out + ".metrics.json") as f:
        got = json.load(f)["metrics"]["dispatches"]
    want = ref_run_pipeline(*inputs, None, RefConfig(**_lambda_cfg(device_scoring="on").__dict__),
                            mesh=make_walk_mesh(1) if mesh else None)
    assert sorted(got) == sorted(want.metrics.as_dict()["metrics"]["dispatches"])
    walk_key = f"run_walks:W512:S24{':D1' if mesh else ''}"
    assert {"score_edges:8192", walk_key} <= set(got), sorted(got)
    for rec in got.values():
        assert len(rec["s"]) == 1 and rec["s"][0] >= 0 and rec["slow"] is False
    assert set(json.loads(history.read_text())) == set(got)


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter: import the whole port and run its lambda pipeline on
    one device, then on a gloo world of 1 in both graph placements, with graph
    and walks artifacts saved and resumed and a profiler trace, then gap_report
    on those artifacts."""
    code = f"""
import sys
import telomeri_tpu_torch.cli.main, telomeri_tpu_torch.interop, telomeri_tpu_torch.kernels.build
import telomeri_tpu_torch.consensus.coherence, telomeri_tpu_torch.consensus.evidence
import telomeri_tpu_torch.dist.mesh, telomeri_tpu_torch.dist.rowshard
import telomeri_tpu_torch.io.artifacts, telomeri_tpu_torch.utils.profiling
import telomeri_tpu_torch.walk.oracle, telomeri_tpu_torch.bench, telomeri_tpu_torch.gap_report
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.dist.mesh import init_distributed, make_walk_mesh, shutdown_distributed
from telomeri_tpu_torch.pipeline import run_pipeline
import json, os
d, t = {LAMBDA!r}, {str(tmp_path)!r}
inputs = [d + "/" + f for f in {INPUTS!r}]
golden = open(d + "/golden_scaffolds.fa", "rb").read()
cfg = ScaffoldConfig(**json.load(open(d + "/config.json")), device_scoring="on")
run_pipeline(*inputs, t + "/x.fa", cfg, device="cpu")
init_distributed("cpu")
mesh = make_walk_mesh(1, "cpu")
for pl in ("replicated", "rowshard"):
    c = ScaffoldConfig(**{{**cfg.__dict__, "graph_placement": pl}})
    run_pipeline(*inputs, t + "/" + pl + ".fa", c, mesh=mesh, save_graph_path=t + "/g.npz",
                 save_walks_path=t + "/w.npz", trace_dir=t + "/trace_" + pl)
    run_pipeline(inputs[0], inputs[1], None, None, t + "/resumed.fa", c, mesh=mesh,
                 graph_artifact=t + "/g.npz", walks_artifact=t + "/w.npz")
    for f in (pl + ".fa", "resumed.fa"):
        assert open(t + "/" + f, "rb").read() == golden, (pl, f)
    assert os.listdir(t + "/trace_" + pl), pl
shutdown_distributed()
run = t + "/run"
os.makedirs(run)
os.replace(t + "/g.npz", run + "/graph.npz")
os.replace(t + "/w.npz", run + "/walks.npz")
open(run + "/out.config.json", "w").write(c.to_json())
assert telomeri_tpu_torch.gap_report.main([run, "--device", "cpu"]) == 0
print("JAX_LOADED" if "jax" in sys.modules else "JAX_ABSENT")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "JAX_ABSENT"


def test_chip_smoke_names_only_the_port():
    """chip_smoke.py reaches the system through the port's modules alone."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert any(n.startswith("telomeri_tpu_torch") for n in names)
    for n in names:
        top = n.split(".")[0]
        assert top not in ("jax", "jaxlib", "telomeri_tpu"), n


def test_probe_on_cpu():
    """The timing probe's three parts (since folded into the bench:
    BENCH_SCALE=ecoli-stages) at a small size on CPU tensors."""
    from telomeri_tpu_torch import bench as probe

    runs = probe.pipeline_runs(LAMBDA, "cpu", runs=1)
    assert len(runs["wall_s"]) == 1 and runs["wall_s"][0] > 0
    assert {"parse_paf", "score_edges_device", "run_walks", "consensus"} <= \
        set(runs["stage_median_s"])
    assert probe.device_profile(LAMBDA, "cpu")["measured"] is False
    (row,) = probe.scoring_cutover("cpu", sizes=(1000,), repeats=1)
    assert row["edges"] == 1000 and row["host_ms"] > 0 and row["device_round_trip_ms"] > 0


def test_cuda_device_is_required_not_emulated(tmp_path):
    """--device cuda without a card is an error, never a silent CPU run; CPU
    tensors never reach a kernel."""
    from telomeri_tpu_torch.kernels import walk_scan

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], None, _lambda_cfg(),
                     device="cuda")
    wide = torch.zeros((8, 6 * 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        walk_scan.walk_scan_cuda(wide, torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32), 0, 3)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Runs on a card without jax too:
    python -m pytest tests/test_torch_pipeline.py -m gpu --noconftest"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from telomeri_tpu_torch.kernels import scoring, walk_scan
    from telomeri_tpu_torch.kernels.walk_common import stable_bits_table
    from telomeri_tpu_torch.kernels.walk_table import pack_wide

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    geom = [torch.from_numpy(rng.integers(-3000, 2**31 - 1, 100_003).astype(np.int32)).to(dev)
            for _ in range(8)]
    for offset in (0, 1, 3):   # whole tensors take the 16-byte kernel, offset views the 4-byte
        views = [a[offset:] for a in geom]
        for outputs in (4, 2):
            want = scoring.score_overlaps_torch(*views, outputs=outputs)
            got = scoring.score_overlaps_cuda(*views, outputs=outputs)
            for a, b in zip(want, got):
                assert b.is_contiguous() and b.shape == a.shape
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # a random packed table: rows of 0..K edges, some dead (all-zero weights)
    n, k, h = 800, 48, 64
    deg = rng.integers(0, k + 1, n)
    slot = np.arange(k)[None, :] < deg[:, None]
    nbr = np.where(slot, rng.integers(0, n, (n, k)), -1)
    es = np.where(slot & (rng.random((n, k)) < 0.9), rng.uniform(0.5, 50, (n, k)), 0)
    cum = np.cumsum(np.ceil(es), axis=1).astype(np.int32)
    wide = torch.from_numpy(pack_wide(nbr, cum, np.where(slot, 7, -1), np.where(slot, 3, 0),
                                      es, es, h)).to(dev)
    start = torch.from_numpy(rng.integers(0, n, 5000).astype(np.int32)).to(dev)
    uid = torch.arange(5000, dtype=torch.int32, device=dev)
    uid[2500:] += 1 << 30
    for seed, steps in ((9, 24), (-9, 33)):
        want = walk_scan.walk_scan_torch(wide, start, stable_bits_table(seed, uid, steps), steps)
        got = walk_scan.walk_scan_cuda(wide, start, uid, seed, steps)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (seed, steps)
    # event resolution on the kernel's records, and greedy / mixed sections with
    # forced first edges (some past the row) and inactive walks, on the same table
    from telomeri_tpu_torch.kernels import greedy_scan, walk_events
    from telomeri_tpu_torch.walk.engine import PlanDev

    bits_of = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    on_card = lambda a: torch.from_numpy(a).to(dev)
    active = on_card(rng.random(5000) < 0.9)
    first_edge = on_card(np.where(rng.random(5000) < 0.3, rng.integers(0, h + 4, 5000), -1)
                         .astype(np.int32))
    pd = PlanDev(start=start, first_edge=first_edge, mode=on_card(rng.integers(0, 3, 5000)
                                                                   .astype(np.int32)),
                 uid=uid, active=active)
    for seed, steps in ((9, 24), (-9, 33), (3, 96)):
        recs = walk_scan.walk_scan_cuda(wide, start, uid, seed, steps)
        kw = dict(n_anchors=20, max_steps=steps)
        pairs = [(walk_events.resolve_events_torch(start, active, *recs, n_nodes=n, **kw),
                  walk_events.resolve_events_cuda(start, active, *recs, **kw))]
        for kind in ("greedy", "mixed"):
            pairs.append((greedy_scan.greedy_scan_torch(wide, pd, seed, 20, steps, kind),
                          greedy_scan.greedy_scan_cuda(wide, pd, seed, 20, steps, kind)))
        torch.cuda.synchronize()
        for i, (want, got) in enumerate(pairs):
            for f, a, b in zip(("nodes", "eids", "steps", "success", "terminal", "path_len",
                                "score_sum"), want, got):
                assert a.dtype == b.dtype and torch.equal(bits_of(a), bits_of(b)), (i, f, steps)
    # long walks: forward edges only (node u to u+1 .. u+3), anchors at the end
    # of the line, so walks run thousands of steps. At 512 steps a block of the
    # event resolution takes fewer than 64 walks; at MAX_STEPS one walk, and
    # the greedy scan one warp, each past 48 KB of shared memory
    from telomeri_tpu_torch.kernels.walk_common import MAX_STEPS

    for steps, n, w in ((512, 800, 3000), (MAX_STEPS, 32_000, 40)):
        nbr = np.minimum(np.arange(n)[:, None] + np.arange(1, 4)[None, :], n - 1)
        nbr[-1] = [0, 1, -1]   # the last node leads back to two anchors
        ok = nbr >= 0
        es = np.where(ok, rng.uniform(0.5, 50, (n, 3)), 0)
        wide = torch.from_numpy(pack_wide(nbr, np.cumsum(np.ceil(es), axis=1).astype(np.int32),
                                          np.where(ok, np.arange(3 * n).reshape(n, 3), -1),
                                          np.where(ok, rng.integers(1, 500, (n, 3)), 0), es,
                                          np.where(ok, rng.uniform(0.5, 50, (n, 3)), 0),
                                          h)).to(dev)
        start = on_card(rng.integers(40, 200, w).astype(np.int32))
        pd = PlanDev(start=start, first_edge=on_card(np.where(np.arange(w) % 5 == 0, 1, -1)
                                                     .astype(np.int32)),
                     mode=on_card((np.arange(w) % 3).astype(np.int32)),
                     uid=torch.arange(w, dtype=torch.int32, device=dev),
                     active=on_card(np.arange(w) % 11 != 0))
        recs = walk_scan.walk_scan_cuda(wide, start, pd.uid, 8, steps)
        kw = dict(n_anchors=20, max_steps=steps)
        pairs = [(walk_events.resolve_events_torch(start, pd.active, *recs, n_nodes=n, **kw),
                  walk_events.resolve_events_cuda(start, pd.active, *recs, **kw))]
        for kind in ("greedy", "mixed"):
            pairs.append((greedy_scan.greedy_scan_torch(wide, pd, 8, 20, steps, kind),
                          greedy_scan.greedy_scan_cuda(wide, pd, 8, 20, steps, kind)))
        torch.cuda.synchronize()
        for i, (want, got) in enumerate(pairs):
            assert int(got[2].max()) > steps // 3, (i, steps)
            for f, a, b in zip(("nodes", "eids", "steps", "success", "terminal", "path_len",
                                "score_sum"), want, got):
                assert a.dtype == b.dtype and torch.equal(bits_of(a), bits_of(b)), (i, f, steps)

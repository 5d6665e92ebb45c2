"""Graph and walks artifacts in the port: round trips, wrong-kind rejection,
the MC cumsum and split-read flags surviving, resume equal to the direct run,
artifacts written by either package resuming in the other with the same FASTA,
and the two packages' walks artifacts equal at 48 steps. The CLI resumes a graph
without the PAF flags, as the reference's does."""

import dataclasses
import json
import os

import numpy as np
import pytest

from telomeri_tpu.config import ScaffoldConfig as RefConfig
from telomeri_tpu.pipeline import run_pipeline as ref_run_pipeline
from telomeri_tpu_torch import interop
from telomeri_tpu_torch.cli.main import main as cli_main
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.io.artifacts import load_graph, load_walks, save_graph, save_walks
from telomeri_tpu_torch.pipeline import build_graph, load_inputs, run_pipeline
from telomeri_tpu_torch.walk.engine import WalkResult

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
CFG = ScaffoldConfig(mc_walks_per_end=30, max_steps=16)


def _paths(d):
    return [os.path.join(d, f) for f in INPUTS]


def _bytes(p) -> bytes:
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def toy_built(toy_dataset_dir):
    contigs, reads, paf = load_inputs(*_paths(toy_dataset_dir))
    return build_graph(contigs, reads, paf, CFG, device="cpu")


def test_graph_artifact_roundtrip(toy_built, tmp_path):
    edges, graph = toy_built
    p = str(tmp_path / "g.npz")
    save_graph(p, edges, graph, CFG)
    e2, g2 = load_graph(p, CFG)
    for f in ("src", "dst", "es", "os_", "el"):
        np.testing.assert_array_equal(getattr(edges, f), getattr(e2, f))
    for f in ("nbr", "eid", "adv", "edge_adv", "cumw", "split_read"):
        np.testing.assert_array_equal(getattr(graph, f), getattr(g2, f))
    assert graph.cumw is not None and graph.split_read is not None
    assert (g2.n_anchors, g2.stats) == (graph.n_anchors, graph.stats)


def test_walks_artifact_roundtrip(toy_built, tmp_path):
    from telomeri_tpu_torch.walk.engine import run_walks_host
    from telomeri_tpu_torch.walk.plan import plan_walks

    _, graph = toy_built
    plan = plan_walks(graph, CFG)
    for name, walks in (("tensors", run_walks_host(graph, plan, CFG, "cpu")),
                        ("numpy", run_walks_host(graph, plan, CFG, "cpu").to_numpy())):
        p = str(tmp_path / f"w_{name}.npz")
        save_walks(p, plan, walks, CFG)
        plan2, got = load_walks(p, CFG)
        assert isinstance(got, WalkResult)
        for f, a, b in zip(WalkResult._fields, walks.to_numpy(), got):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(plan2.uid, plan.uid)


def test_wrong_kind_rejected(toy_built, tmp_path):
    edges, graph = toy_built
    p = str(tmp_path / "g.npz")
    save_graph(p, edges, graph, CFG)
    with pytest.raises(ValueError, match="expected 'walks'"):
        load_walks(p, CFG)


def test_resume_from_artifacts_identical_output(toy_dataset_dir, tmp_path):
    args = _paths(toy_dataset_dir)
    out0, gp, wp = (str(tmp_path / f) for f in ("direct.fa", "graph.npz", "walks.npz"))
    run_pipeline(*args, out0, CFG, save_graph_path=gp, save_walks_path=wp, device="cpu")
    out1 = str(tmp_path / "from_graph.fa")
    run_pipeline(args[0], args[1], None, None, out1, CFG, graph_artifact=gp, device="cpu")
    out2 = str(tmp_path / "from_walks.fa")
    run_pipeline(args[0], args[1], None, None, out2, CFG, graph_artifact=gp,
                 walks_artifact=wp, device="cpu")
    assert _bytes(out1) == _bytes(out0) and _bytes(out2) == _bytes(out0)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_artifacts_resume_across_packages(toy_dataset_dir, tmp_path, writer):
    """Written by one package, resumed by the other: the writer's FASTA."""
    cfg = RefConfig(mc_walks_per_end=50, max_steps=32, rescue_walks_per_end=200)
    args = _paths(toy_dataset_dir)
    gp, wp = str(tmp_path / "g.npz"), str(tmp_path / "w.npz")
    out0 = str(tmp_path / "direct.fa")
    port_run = lambda *a, **kw: run_pipeline(
        *a[:-1], interop.config_from_reference(a[-1]), **kw, device="cpu")
    write, resume = ((ref_run_pipeline, port_run) if writer == "reference"
                     else (port_run, ref_run_pipeline))
    write(*args, out0, cfg, save_graph_path=gp, save_walks_path=wp)
    out1, out2 = str(tmp_path / "graph.fa"), str(tmp_path / "walks.fa")
    resume(args[0], args[1], None, None, out1, cfg, graph_artifact=gp)
    resume(args[0], args[1], None, None, out2, cfg, graph_artifact=gp, walks_artifact=wp)
    assert _bytes(out1) == _bytes(out0) and _bytes(out2) == _bytes(out0)


def test_walks_artifacts_of_both_packages_equal_above_32_steps(tmp_path_factory, tmp_path):
    """At 48 steps, where score_sum takes XLA's windowed order (on the spanning
    reads of test_torch_scenarios.py, whose sums the order changes), the two
    packages' walks.npz hold the same arrays, float32 compared by their bits."""
    from test_torch_scenarios import SPANNING_SIM, write_sim

    cfg = RefConfig(mc_walks_per_end=40, max_steps=48)
    args = _paths(write_sim(tmp_path_factory, "spanning", SPANNING_SIM))
    ref_run_pipeline(*args, None, cfg, save_walks_path=str(tmp_path / "ref.npz"))
    run_pipeline(*args, None, interop.config_from_reference(cfg),
                 save_walks_path=str(tmp_path / "port.npz"), device="cpu")
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert (a["walk_steps"] > cfg.max_steps // 2).any()   # sums that span both windows
        for f in a.files:
            x, y = a[f], b[f]
            assert x.dtype == y.dtype and x.shape == y.shape, f
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(y, x, err_msg=f)


def test_graph_artifact_without_split_read_loads_none(toy_built, tmp_path):
    """An artifact from before the split-read flags loads with split_read=None."""
    edges, graph = toy_built
    p = str(tmp_path / "g_old.npz")
    save_graph(p, edges, dataclasses.replace(graph, split_read=None), CFG)
    _, g2 = load_graph(p, CFG)
    assert g2.split_read is None


def test_cli_resumes_lambda_graph_without_paf_flags(tmp_path):
    """--graph needs no --paf-read-* (the reference CLI's rule), on one device
    and on a mesh of 1, and gives the golden FASTA."""
    common = ["scaffold", "--device", "cpu", "--config", os.path.join(LAMBDA, "config.json"),
              "--contigs", os.path.join(LAMBDA, "contigs.fa"),
              "--reads", os.path.join(LAMBDA, "reads.fa")]
    g = str(tmp_path / "g.npz")
    assert cli_main(common + ["--paf-read-contig", os.path.join(LAMBDA, "read2contig.paf"),
                              "--paf-read-read", os.path.join(LAMBDA, "read2read.paf"),
                              "--save-graph", g, "--out", str(tmp_path / "a.fa")]) == 0
    golden = _bytes(os.path.join(LAMBDA, "golden_scaffolds.fa"))
    for name, extra in (("one", []), ("mesh", ["--mesh", "1"])):
        out = str(tmp_path / f"{name}.fa")
        assert cli_main(common + ["--graph", g, "--out", out] + extra) == 0
        assert _bytes(out) == golden
        with open(out + ".metrics.json") as f:
            assert "load_graph_artifact" in json.load(f)["timings_s"]
    with pytest.raises(SystemExit):   # without --graph the PAF flags stay required
        cli_main(common + ["--out", str(tmp_path / "x.fa")])


def _active_by_uid(path: str) -> dict:
    """A walks artifact's active rows in uid order: plan and record arrays."""
    with np.load(path, allow_pickle=False) as z:
        keep = np.flatnonzero(z["plan_active"])
        order = keep[np.argsort(z["plan_uid"][keep], kind="stable")]
        return {f: z[f][order] for f in z.files if f != "header"}


def test_save_walks_on_a_one_host_mesh(toy_dataset_dir, tmp_path):
    """A gloo world of 2 on one host saves the records (every rank joins the
    fetch, rank 0 writes): the one-device artifact's arrays, walk by walk, and
    both packages resume from it to the direct run's FASTA."""
    from test_torch_dist import run_cli

    cfg = RefConfig(mc_walks_per_end=50, max_steps=32, rescue_walks_per_end=200)
    args = _paths(toy_dataset_dir)
    one_fa, one_w = str(tmp_path / "one.fa"), str(tmp_path / "one_walks.npz")
    run_pipeline(*args, one_fa, interop.config_from_reference(cfg), save_walks_path=one_w,
                 device="cpu")
    mesh_fa, gp, wp = (str(tmp_path / f) for f in ("mesh.fa", "g.npz", "w.npz"))
    flags = ["--mc-walks-per-end", "50", "--max-steps", "32", "--rescue-walks-per-end", "200"]
    proc = run_cli([], ["scaffold", "--device", "cpu", "--mesh", "2", "--contigs", args[0],
                        "--reads", args[1], "--paf-read-contig", args[2],
                        "--paf-read-read", args[3], "--out", mesh_fa, "--save-graph", gp,
                        "--save-walks", wp, *flags], str(tmp_path / "cache"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--save-walks skipped" not in proc.stderr
    assert _bytes(mesh_fa) == _bytes(one_fa)
    with open(mesh_fa + ".metrics.json") as f:
        assert "save_walks_artifact" in json.load(f)["timings_s"]
    one, got = _active_by_uid(one_w), _active_by_uid(wp)
    assert sorted(one) == sorted(got) and len(one["plan_uid"]) > 0
    for f in one:
        a, b = one[f], got[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f)
    out_port, out_ref = str(tmp_path / "port.fa"), str(tmp_path / "ref.fa")
    run_pipeline(args[0], args[1], None, None, out_port, interop.config_from_reference(cfg),
                 graph_artifact=gp, walks_artifact=wp, device="cpu")
    ref_run_pipeline(args[0], args[1], None, None, out_ref, cfg, graph_artifact=gp,
                     walks_artifact=wp)
    assert _bytes(out_port) == _bytes(one_fa) and _bytes(out_ref) == _bytes(one_fa)


def test_save_walks_skipped_only_across_hosts(monkeypatch):
    """The reference skips where jax.process_count() > 1: a world with ranks on
    another host. One host's world, however large, saves."""
    import torch

    from telomeri_tpu_torch.dist.mesh import WalkMesh, spans_hosts

    mesh = WalkMesh(None, 0, 8, 0, torch.device("cpu"))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert not spans_hosts(mesh)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert not spans_hosts(mesh)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert spans_hosts(mesh)

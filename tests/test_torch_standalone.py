"""The port stands alone: no module of telomeri_tpu_torch, and not
chip_smoke.py, imports telomeri_tpu or jax (an AST walk over the sources), a
fresh interpreter that drives every entry point of the port ends with neither
in sys.modules, and every module that the port copied from the reference gives
the reference's results on the same inputs (equal arrays, equal bytes)."""

import ast
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import telomeri_tpu.config
import telomeri_tpu.consensus.coherence
import telomeri_tpu.consensus.evidence
import telomeri_tpu.graph.tensorize
import telomeri_tpu.io.fasta
import telomeri_tpu.io.geometry
import telomeri_tpu.io.paf
import telomeri_tpu.scaffold.bridge
import telomeri_tpu.scaffold.polish
import telomeri_tpu.scaffold.stitch
import telomeri_tpu.sim
import telomeri_tpu.utils.stats
import telomeri_tpu.utils.validate
import telomeri_tpu.walk.plan
import telomeri_tpu_torch.config
import telomeri_tpu_torch.consensus.coherence
import telomeri_tpu_torch.consensus.evidence
import telomeri_tpu_torch.graph.tensorize
import telomeri_tpu_torch.io.fasta
import telomeri_tpu_torch.io.geometry
import telomeri_tpu_torch.io.paf
import telomeri_tpu_torch.scaffold.bridge
import telomeri_tpu_torch.scaffold.polish
import telomeri_tpu_torch.scaffold.stitch
import telomeri_tpu_torch.sim
import telomeri_tpu_torch.utils.stats
import telomeri_tpu_torch.utils.validate
import telomeri_tpu_torch.walk.plan
from telomeri_tpu_torch import interop

REF, PORT = telomeri_tpu, telomeri_tpu_torch
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
TOY_SIM = dict(genome_len=60_000, repeat_len=3_000, n_repeat_copies=3, coverage=12.0,
               error_rate=0.02, chimera_rate=0.05, seed=17)


def test_no_source_file_imports_the_reference_or_jax():
    files = sorted(glob.glob(os.path.join(ROOT, "telomeri_tpu_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("telomeri_tpu", "jax", "jaxlib"), \
                    f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {n}"


def test_every_entry_point_leaves_the_reference_and_jax_unloaded(tmp_path):
    """One fresh interpreter: every module of the port imported, the lambda
    pipeline on one device and on a gloo world of 1 in both placements with
    artifacts saved, resumed and traced, gap_report on them, and simulate,
    stats, validate and scaffold through the CLI."""
    code = f"""
import glob, importlib, json, os, sys
root, d, t = {ROOT!r}, {LAMBDA!r}, {str(tmp_path)!r}
for path in sorted(glob.glob(root + "/telomeri_tpu_torch/**/*.py", recursive=True)):
    mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
    importlib.import_module(mod[:-9] if mod.endswith(".__init__") else mod)
from telomeri_tpu_torch import gap_report
from telomeri_tpu_torch.cli.main import main as cli
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.dist.mesh import init_distributed, make_walk_mesh, shutdown_distributed
from telomeri_tpu_torch.pipeline import run_pipeline
inputs = [d + "/" + f for f in {INPUTS!r}]
golden = open(d + "/golden_scaffolds.fa", "rb").read()
cfg = ScaffoldConfig(**json.load(open(d + "/config.json")), device_scoring="on")
run_pipeline(*inputs, t + "/x.fa", cfg, device="cpu")
assert open(t + "/x.fa", "rb").read() == golden
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
shutdown_distributed()
run = t + "/run"
os.makedirs(run)
os.replace(t + "/g.npz", run + "/graph.npz")
os.replace(t + "/w.npz", run + "/walks.npz")
open(run + "/out.config.json", "w").write(c.to_json())
assert gap_report.main([run, "--device", "cpu"]) == 0
sim = t + "/sim"
assert cli(["simulate", "--out", sim, "--genome-len", "40000", "--repeat-len", "2000",
            "--coverage", "10", "--seed", "3"]) == 0
assert cli(["stats", sim + "/contigs.fa", sim + "/reads.fa"]) == 0
assert cli(["scaffold", "--device", "cpu", "--contigs", sim + "/contigs.fa",
            "--reads", sim + "/reads.fa", "--paf-read-contig", sim + "/read2contig.paf",
            "--paf-read-read", sim + "/read2read.paf", "--out", sim + "/out.fa",
            "--agp", sim + "/out.agp", "--mc-walks-per-end", "40"]) == 0
assert cli(["validate", "--scaffolds", sim + "/out.fa", "--genome", sim + "/genome.fa",
            "--agp", sim + "/out.agp", "--index-cache", "off", "--jobs", "1"]) == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("telomeri_tpu", "jax", "jaxlib"))
print("LOADED", loaded)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["TELOMERI_CACHE"] = str(tmp_path / "cache")   # the dispatch history stays out of $HOME
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"


# --- each copied module against the reference, on the same inputs -------------------

def _fields_equal(a, b, what=""):
    """Two dataclass instances (one of either package) field by field."""
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f"{what}{f.name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{what}{f.name}")
        else:
            assert x == y, f"{what}{f.name}"


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def stages():
    """The lambda inputs through both packages' host stages, side by side:
    name -> (reference's result, port's result)."""
    out = {}
    paths = [os.path.join(LAMBDA, f) for f in INPUTS]
    with open(os.path.join(LAMBDA, "config.json")) as f:
        text = f.read()
    cfgs = out["config"] = (REF.config.ScaffoldConfig.from_json(text),
                            PORT.config.ScaffoldConfig.from_json(text))
    seqs = {}
    for key, pkg in (("ref", REF), ("port", PORT)):
        contigs, reads = pkg.io.fasta.read_fasta(paths[0]), pkg.io.fasta.read_fasta(paths[1])
        index = {n: i for i, n in enumerate(list(contigs.names) + list(reads.names))}
        paf = pkg.io.paf.PafRecords.concatenate(
            [pkg.io.paf.parse_paf(p, index) for p in paths[2:]])
        seqs[key] = (contigs, reads, paf)
    out["fasta"] = (seqs["ref"][:2], seqs["port"][:2])
    out["paf"] = (seqs["ref"][2], seqs["port"][2])
    n_seqs = len(seqs["ref"][0]) + len(seqs["ref"][1])
    out["edges"] = tuple(pkg.io.geometry.build_edges(s[2], cfg, n_seqs)
                         for pkg, s, cfg in zip((REF, PORT), seqs.values(), cfgs))
    out["split"] = tuple(
        pkg.io.geometry.split_mapped(
            s[2], n_seqs, min_overlap=cfg.split_read_margin,
            row_mask=pkg.io.geometry.split_evidence_mask(s[2], cfg.min_identity))
        for pkg, s, cfg in zip((REF, PORT), seqs.values(), cfgs))
    seq_len = np.concatenate([seqs["ref"][0].lengths, seqs["ref"][1].lengths])
    out["graph"] = tuple(
        pkg.graph.tensorize.tensorize(e[0], seq_len, len(seqs["ref"][0]), cfg)
        for pkg, e, cfg in zip((REF, PORT), out["edges"], cfgs))
    out["plan"] = tuple(pkg.walk.plan.plan_walks(g, cfg, n_shards=2)
                        for pkg, g, cfg in zip((REF, PORT), out["graph"], cfgs))
    return out


@pytest.fixture(scope="module")
def lambda_run(tmp_path_factory):
    """The port's lambda run: what the consensus, gate, stitch and polish cases read."""
    from telomeri_tpu_torch.pipeline import run_pipeline

    with open(os.path.join(LAMBDA, "config.json")) as f:
        cfg = PORT.config.ScaffoldConfig(**{**json.load(f), "polish": True})
    out = str(tmp_path_factory.mktemp("standalone") / "lambda.fa")
    res = run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], out, cfg, device="cpu")
    return cfg, res


def check_config(stages, lambda_run, tmp_path):
    ref, port = stages["config"]
    assert port.to_json() == ref.to_json()
    assert dataclasses.asdict(PORT.config.ScaffoldConfig.from_json(ref.to_json())) == \
        dataclasses.asdict(ref)
    assert dataclasses.asdict(PORT.config.DEFAULT_CONFIG) == \
        dataclasses.asdict(REF.config.DEFAULT_CONFIG)
    assert interop.config_from_reference(ref) == port
    old = json.dumps({**json.loads(ref.to_json()), "mc_phase_steps": 8})   # a dropped key
    assert PORT.config.ScaffoldConfig.from_json(old) == port


def check_read_fasta(stages, lambda_run, tmp_path):
    for ref, port in zip(*stages["fasta"]):
        assert list(port.names) == list(ref.names) and len(port) == len(ref) > 0
        np.testing.assert_array_equal(port.lengths, ref.lengths)
        for i in (0, len(ref) // 2, len(ref) - 1):
            np.testing.assert_array_equal(np.asarray(port.seqs[i]), np.asarray(ref.seqs[i]))
    contigs = stages["fasta"][0][0]
    names, seqs = list(contigs.names), list(contigs.seqs)
    REF.io.fasta.write_fasta(str(tmp_path / "ref.fa"), names, seqs)
    PORT.io.fasta.write_fasta(str(tmp_path / "port.fa"), names, seqs)
    assert _read_bytes(tmp_path / "port.fa") == _read_bytes(tmp_path / "ref.fa")


def check_parse_paf(stages, lambda_run, tmp_path):
    ref, port = stages["paf"]
    assert len(ref) > 1000
    _fields_equal(ref, port)
    _fields_equal(interop.paf_from_reference(ref), port)


def check_build_edges(stages, lambda_run, tmp_path):
    (ref, ref_stats), (port, port_stats) = stages["edges"]
    assert len(ref) > 1000 and port_stats.as_dict() == ref_stats.as_dict()
    _fields_equal(ref, port)
    _fields_equal(interop.edges_from_reference(ref), port)
    np.testing.assert_array_equal(stages["split"][1], stages["split"][0])


def check_tensorize(stages, lambda_run, tmp_path):
    ref, port = stages["graph"]
    assert port.virtual_base == ref.virtual_base and port.n_nodes == ref.n_nodes
    _fields_equal(ref, port)
    _fields_equal(interop.graph_from_reference(ref), port)
    for n in (0, 1, 7, 8, 100, 1000, 12345, 10**6 + 1):
        assert PORT.utils.shapes.bucket_len(n, 8) == REF.utils.shapes.bucket_len(n, 8)


def check_plan_walks(stages, lambda_run, tmp_path):
    ref, port = stages["plan"]
    assert len(ref) > 100 and port.n_active == ref.n_active
    _fields_equal(ref, port)
    _fields_equal(interop.plan_from_reference(ref), port)
    np.testing.assert_array_equal(port.uid_to_row(), ref.uid_to_row())
    assert (PORT.walk.plan.MODE_GREEDY_OS, PORT.walk.plan.MODE_GREEDY_ES,
            PORT.walk.plan.MODE_MC) == (REF.walk.plan.MODE_GREEDY_OS,
                                        REF.walk.plan.MODE_GREEDY_ES, REF.walk.plan.MODE_MC)


def _gate_rows(lambda_run):
    from telomeri_tpu_torch.consensus.grouping import compress
    from telomeri_tpu_torch.pipeline import _consensus

    cfg, res = lambda_run
    cons = _consensus(res.walks, res.plan, res.graph, cfg, "cpu")
    return cons, compress(cons)


def check_read_diversity_gate(stages, lambda_run, tmp_path):
    cfg, res = lambda_run
    cons, rows = _gate_rows(lambda_run)
    assert rows
    for split in (res.graph.split_read, None):   # None: every cut read is suspect
        want = REF.consensus.evidence.read_diversity_gate(
            [dict(r) for r in rows], cons, res.walks, res.graph.virtual_base, split_read=split)
        got = PORT.consensus.evidence.read_diversity_gate(
            [dict(r) for r in rows], cons, res.walks, res.graph.virtual_base, split_read=split)
        assert got == want
    assert PORT.consensus.evidence.interior_reads(res.walks.nodes[0], 3, 10**6) == \
        REF.consensus.evidence.interior_reads(res.walks.nodes[0], 3, 10**6)


def check_annotate_pair_coherence(stages, lambda_run, tmp_path):
    cfg, res = lambda_run
    cons, rows = _gate_rows(lambda_run)
    np.testing.assert_array_equal(PORT.consensus.coherence.edge_coherence_rel(res.edges),
                                  REF.consensus.coherence.edge_coherence_rel(res.edges))
    for margin in (0.005, 0.05, 0.0):
        want, got = [dict(r) for r in rows], [dict(r) for r in rows]
        n_want = REF.consensus.coherence.annotate_pair_coherence(
            want, cons, res.walks, res.edges, res.graph.virtual_base, margin)
        n_got = PORT.consensus.coherence.annotate_pair_coherence(
            got, cons, res.walks, res.edges, res.graph.virtual_base, margin)
        assert (n_got, got) == (n_want, want)


def check_resolve_with_blockers(stages, lambda_run, tmp_path):
    cfg, res = lambda_run
    rows = [dict(r) for r in res.bridges]
    rng = np.random.default_rng(8)
    for trial in range(4):   # the run's rows, then conflicting and blocked variants of them
        blocked = []
        if trial:
            extra = [dict(r, pair=(r["pair"][0], int(rng.integers(0, 12))),
                          count=int(rng.integers(1, 50)), coherent=bool(trial % 2))
                     for r in rows]
            rows, blocked = rows + extra, extra[:trial]
        want = REF.scaffold.bridge.resolve_with_blockers(rows, blocked)
        got = PORT.scaffold.bridge.resolve_with_blockers(rows, blocked)
        assert [dataclasses.asdict(b) for b in got[0]] == [dataclasses.asdict(b) for b in want[0]]
        assert {dataclasses.astuple(e) for e in got[1]} == {dataclasses.astuple(e) for e in want[1]}
    for u in range(12):
        assert dataclasses.astuple(PORT.scaffold.bridge.start_end(u)) == \
            dataclasses.astuple(REF.scaffold.bridge.start_end(u))
        assert dataclasses.astuple(PORT.scaffold.bridge.terminal_end(u)) == \
            dataclasses.astuple(REF.scaffold.bridge.terminal_end(u))


def _scaffolds(pkg, lambda_run, stages, which):
    """The accepted bridges of the port's run stitched by `pkg`'s Stitcher."""
    cfg, res = lambda_run
    contigs, reads = stages["fasta"][which]
    lut = res.plan.uid_to_row()
    paths = {b.rep_uid: pkg.scaffold.stitch.extract_path(
        res.walks.nodes[lut[b.rep_uid]], res.walks.eids[lut[b.rep_uid]],
        int(res.walks.steps[lut[b.rep_uid]]), virtual_base=res.graph.virtual_base)
        for b in res.accepted}
    accepted = [pkg.scaffold.bridge.Bridge(**{
        **{f.name: getattr(b, f.name) for f in dataclasses.fields(b)},
        "end_a": pkg.scaffold.bridge.End(*dataclasses.astuple(b.end_a)),
        "end_b": pkg.scaffold.bridge.End(*dataclasses.astuple(b.end_b))}) for b in res.accepted]
    stitcher = pkg.scaffold.stitch.Stitcher(contigs, reads, stages["edges"][which][0])
    return pkg.scaffold.stitch.emit_scaffolds(accepted, paths, stitcher), contigs, reads


def check_stitcher(stages, lambda_run, tmp_path):
    (want, contigs, reads), (got, _, _) = (_scaffolds(pkg, lambda_run, stages, i)
                                           for i, pkg in enumerate((REF, PORT)))
    assert len(lambda_run[1].accepted) >= 1
    assert [s.name for s in got] == [s.name for s in want] and want
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b.seq), np.asarray(a.seq))
    REF.scaffold.stitch.write_agp(str(tmp_path / "ref.agp"), want, contigs, reads)
    PORT.scaffold.stitch.write_agp(str(tmp_path / "port.agp"), got, *stages["fasta"][1])
    assert _read_bytes(tmp_path / "port.agp") == _read_bytes(tmp_path / "ref.agp")


def check_polish_scaffolds(stages, lambda_run, tmp_path):
    cfg, res = lambda_run
    junction_reads = {tuple(r["pair"]): r["span_reads"] for r in res.bridges
                      if "span_reads" in r}
    assert junction_reads
    results = []
    for i, pkg in enumerate((REF, PORT)):
        scaffolds, contigs, reads = _scaffolds(pkg, lambda_run, stages, i)
        agg = pkg.scaffold.polish.polish_scaffolds(scaffolds, reads, junction_reads,
                                                   len(contigs), flank=cfg.polish_flank)
        results.append((agg, [np.asarray(s.seq).tobytes() for s in scaffolds]))
    assert results[1] == results[0]
    assert results[0][0]["segments"] > 0


def check_simulate(stages, lambda_run, tmp_path):
    for kw in (TOY_SIM, dict(TOY_SIM, inverted_copies=(1,), het_rate=0.002, end_jitter=10,
                             ins_rate=0.01, del_rate=0.01, seed=18)):
        for name, pkg in (("ref", REF), ("port", PORT)):
            pkg.sim.write_dataset(pkg.sim.simulate(pkg.sim.SimConfig(**kw)),
                                  str(tmp_path / name))
        files = sorted(os.listdir(tmp_path / "ref"))
        assert files == sorted(os.listdir(tmp_path / "port")) and len(files) >= 5
        for f in files:
            assert _read_bytes(tmp_path / "port" / f) == _read_bytes(tmp_path / "ref" / f), f
    assert {k: dataclasses.asdict(v) for k, v in PORT.sim.PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF.sim.PRESETS.items()}


def check_validate_assembly(stages, lambda_run, tmp_path):
    PORT.sim.write_dataset(PORT.sim.simulate(PORT.sim.SimConfig(**TOY_SIM)), str(tmp_path / "d"))
    reports = []
    for pkg in (REF, PORT):
        genome = pkg.io.fasta.read_fasta(str(tmp_path / "d" / "genome.fa"))
        contigs = pkg.io.fasta.read_fasta(str(tmp_path / "d" / "contigs.fa"))
        reports.append(pkg.utils.validate.validate_assembly(
            contigs, genome, k=24, stride=32, n_jobs=1, index_cache_dir=None))
        reports.append(pkg.utils.stats.assembly_stats(contigs.lengths))
        reports.append(pkg.utils.stats.scaffold_vs_contig_stats(
            [int(x) for x in genome.lengths], list(contigs.lengths)))
    assert reports[3:] == reports[:3] and reports[0]["n_placed"] >= 1


@pytest.mark.parametrize("check", [
    check_config, check_read_fasta, check_parse_paf, check_build_edges, check_tensorize,
    check_plan_walks, check_resolve_with_blockers, check_stitcher, check_polish_scaffolds,
    check_read_diversity_gate, check_annotate_pair_coherence, check_simulate,
    check_validate_assembly], ids=lambda f: f.__name__[6:])
def test_copied_module_equals_reference(check, stages, lambda_run, tmp_path):
    check(stages, lambda_run, tmp_path)

"""The reference's scenario suite through both packages on the CPU. Each case
simulates a dataset of tests/test_scale.py (or tests/test_fuzz.py's poisoned
PAF), runs telomeri_tpu's run_pipeline and the port's on it, and holds the port
to the reference: the FASTA bytes, the accepted pairs and their representative
uids, the candidate bridges, every walk record (score_sum by its float32 bits)
and every metric except the device, the scoring backend, the parser backend
(each package has its own native library) and the dispatch times; the accepted pairs are also the reference test's.

This file: a rescue round that fires with polish on, the chimera bait at
support 1 under both support modes, spanning reads with hub rows and the
poisoned PAF, then gap_report against tools/gap_report.py on two runs with
missed gaps. test_torch_scenarios_repeats.py holds the repeats longer than
reads at 48 and 96 steps, and the het bubbles."""

import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_dist import assert_records_equal

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.pipeline import run_pipeline as ref_run_pipeline
from telomeri_tpu.sim import SimConfig, simulate, write_dataset
from telomeri_tpu_torch import gap_report, interop
from telomeri_tpu_torch.native import paf_native
from telomeri_tpu_torch.pipeline import run_pipeline

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")

RESCUE_SIM = SimConfig(
    genome_len=220_000, repeat_len=12_000, n_repeat_copies=3, read_len_mean=2_200,
    read_len_sd=300, coverage=14.0, error_rate=0.02, cross_copy_overlaps=True,
    copy_divergence=0.02, seed=2)
RESCUE_CFG = ScaffoldConfig(mc_walks_per_end=3, max_steps=32, rescue_rounds=1,
                            rescue_walks_per_end=800, polish=True)
CHIMERA_SIM = SimConfig(
    genome_len=200_000, repeat_len=4_000, n_repeat_copies=4, read_len_mean=3_000,
    read_len_sd=500, coverage=15.0, error_rate=0.02, chimera_rate=0.2,
    dropout_len=10_000, dropout_starts=(33_800,), seed=3)
CHIMERA_CFG = ScaffoldConfig(mc_walks_per_end=64, max_steps=16, min_group_support=1)
SPANNING_SIM = SimConfig(
    genome_len=240_000, repeat_len=4_000, n_repeat_copies=3, read_len_mean=5_000,
    read_len_sd=1_000, read_min_len=800, coverage=16.0, error_rate=0.02, ins_rate=0.025,
    del_rate=0.025, end_jitter=25, min_sim_overlap=400, cross_copy_overlaps=True, seed=23)
POISON_SIM = SimConfig(
    genome_len=120_000, repeat_len=4_000, n_repeat_copies=3, read_len_mean=2_500,
    read_len_sd=400, coverage=15.0, error_rate=0.02, seed=11)


def adjacent(n_gaps: int) -> set:
    return {(2 * c, 2 * c + 2) for c in range(n_gaps)}


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def inputs(data_dir: str) -> list[str]:
    return [os.path.join(data_dir, f) for f in INPUTS]


def write_sim(tmp_path_factory, name: str, sim: SimConfig) -> str:
    d = str(tmp_path_factory.mktemp(name))
    write_dataset(simulate(sim), d)
    return d


def assert_port_matches_reference(data_dir: str, cfg: ScaffoldConfig, tmp_path, pairs: set):
    """Both pipelines on data_dir; the port equals the reference and accepts
    exactly `pairs`. Returns the port's result."""
    ref_fa, port_fa = str(tmp_path / "ref.fa"), str(tmp_path / "port.fa")
    want = ref_run_pipeline(*inputs(data_dir), ref_fa, cfg)
    got = run_pipeline(*inputs(data_dir), port_fa, interop.config_from_reference(cfg),
                       device="cpu")
    assert read_bytes(port_fa) == read_bytes(ref_fa)
    assert [(b.pair, b.rep_uid) for b in got.accepted] == \
        [(b.pair, b.rep_uid) for b in want.accepted]
    assert {b.pair for b in got.accepted} == pairs
    assert got.bridges == want.bridges
    assert_records_equal(want.walks, got.walks)
    mw, mg = (r.metrics.as_dict()["metrics"] for r in (want, got))
    assert sorted(mg.pop("dispatches")) == sorted(mw.pop("dispatches"))
    for k in ("device", "scoring_backend"):
        mw.pop(k, None)
        mg.pop(k, None)
    # each package loads its own build of the native parsers
    mw.pop("parser_backend")
    assert mg.pop("parser_backend") == ("native" if paf_native.available() else "python")
    assert mg == mw
    return got


@pytest.fixture(autouse=True)
def dispatch_history(tmp_path, monkeypatch):
    """Keep both packages' dispatch watches' cross-run history (one file) out
    of the user's cache."""
    from telomeri_tpu.utils import watchdog
    from telomeri_tpu_torch.utils import watchdog as port_watchdog

    for mod in (watchdog, port_watchdog):
        monkeypatch.setattr(mod, "HISTORY_PATH", str(tmp_path / "dispatch_history.json"))


@pytest.fixture(scope="module")
def rescue_data(tmp_path_factory):
    return write_sim(tmp_path_factory, "rescue", RESCUE_SIM)


@pytest.fixture(scope="module")
def chimera_data(tmp_path_factory):
    return write_sim(tmp_path_factory, "chimera", CHIMERA_SIM)


def test_rescue_round_fires_with_polish(rescue_data, tmp_path):
    got = assert_port_matches_reference(rescue_data, RESCUE_CFG, tmp_path, adjacent(3))
    m = got.metrics.values
    assert m["n_bridges_rescued"] == 1 and "polish" in m and len(got.scaffolds) == 1


@pytest.mark.parametrize("support", ["read_diverse", "walk_count"])
def test_chimera_dropout_at_support_1(chimera_data, tmp_path, support):
    """The gate refuses the chimera under read_diverse; walk_count takes the bait."""
    cfg = dataclasses.replace(CHIMERA_CFG, support_mode=support)
    real = {(2, 4), (4, 6), (6, 8)}   # (0, 2) lies in the dropout
    pairs = real if support == "read_diverse" else real | {(1, 9)}
    got = assert_port_matches_reference(chimera_data, cfg, tmp_path, pairs)
    if support == "read_diverse":
        assert got.metrics.values["n_bridges_cut_refused"] > 0


def test_spanning_reads_with_hub_rows(tmp_path_factory, tmp_path):
    d = write_sim(tmp_path_factory, "spanning", SPANNING_SIM)
    assert_port_matches_reference(d, ScaffoldConfig(mc_walks_per_end=200, max_steps=32),
                                  tmp_path, {(0, 2), (2, 4), (4, 6)})


def test_poisoned_paf(tmp_path_factory, tmp_path):
    """tests/test_fuzz.py's dataset: garbage rows with real names appended to
    both PAF files."""
    d = write_sim(tmp_path_factory, "poisoned", POISON_SIM)
    rng = np.random.default_rng(13)
    with open(os.path.join(d, "reads.fa")) as f:
        names = [ln[1:].strip() for ln in f if ln.startswith(">")]
    poison = []
    for _ in range(200):
        a = names[int(rng.integers(0, len(names)))]
        b = names[int(rng.integers(0, len(names)))]
        if a == b:
            continue
        ql = int(rng.integers(1, 5000))
        poison.append(f"{a}\t{ql}\t{-int(rng.integers(1, 99))}\t"
                      f"{ql + int(rng.integers(1, 500))}\t+\t{b}\t0\t"
                      f"{int(rng.integers(0, 5000))}\t{int(rng.integers(0, 2))}\t"
                      f"{int(rng.integers(500, 5000))}\t0")
    for fn in ("read2contig.paf", "read2read.paf"):
        with open(os.path.join(d, fn), "a") as f:
            f.write("\n".join(poison) + "\n")
    got = assert_port_matches_reference(d, ScaffoldConfig(mc_walks_per_end=60, max_steps=24),
                                        tmp_path, adjacent(3))
    assert got.metrics.values["filter"]["n_malformed"] >= len(poison)


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_gap_report", os.path.join(ROOT, "tools", "gap_report.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _gap_reports(data_dir: str, cfg: ScaffoldConfig, run) -> tuple[str, str]:
    """(the port's report, the reference tool's) on the port's artifacts of
    one run, laid out as `scaffold --save-graph --save-walks` leaves them."""
    run.mkdir()
    run_pipeline(*inputs(data_dir), str(run / "out.fa"), interop.config_from_reference(cfg),
                 device="cpu",
                 save_graph_path=str(run / "graph.npz"), save_walks_path=str(run / "walks.npz"))
    (run / "out.fa.config.json").write_text(cfg.to_json())
    got, want = io.StringIO(), io.StringIO()
    gap_report.diagnose(str(run), out=got, device="cpu")
    _reference_tool().diagnose(str(run), out=want)
    return got.getvalue(), want.getvalue()


def _gap_report_cli(*args: str):
    return subprocess.run([sys.executable, "-m", "telomeri_tpu_torch.gap_report", *args],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))


def test_gap_report_on_a_missed_gap_matches_reference_tool(rescue_data, tmp_path):
    """rescue at rescue_rounds=0 misses one gap; `python -m` prints the same."""
    run = tmp_path / "run"
    cfg = dataclasses.replace(RESCUE_CFG, rescue_rounds=0)
    got, want = _gap_reports(rescue_data, cfg, run)
    assert got == want
    report = json.loads(got)
    assert report["bridged"] == 2 and len(report["missed"]) == 1
    proc = _gap_report_cli(str(run), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want
    if not torch.cuda.is_available():   # the card is the default, and is never emulated
        for args in ([str(run)], ["--device", "cuda", str(run)]):
            proc = _gap_report_cli(*args)
            assert proc.returncode not in (0, None) and proc.stdout == ""
            assert "--device cuda: torch sees no CUDA device (use --device cpu)" in proc.stderr


def test_gap_report_on_chimera_matches_reference_tool(chimera_data, tmp_path):
    got, want = _gap_reports(chimera_data, CHIMERA_CFG, tmp_path / "run")
    assert got == want
    assert [d["gap"] for d in json.loads(got)["missed"]] == [0]   # the dropout gap


def test_gap_report_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """diagnose() defaults to the card and raises without one, before it reads
    the run directory; main() says what the CLI says and returns 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gap_report.diagnose(str(tmp_path / "absent"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gap_report.diagnose(str(tmp_path / "absent"), device="cuda")
    assert gap_report.main([str(tmp_path / "absent")]) == 1
    assert gap_report.main(["--device", "cuda", str(tmp_path / "absent")]) == 1
    with pytest.raises(SystemExit):
        gap_report.main([str(tmp_path / "absent"), "--device", "tpu"])

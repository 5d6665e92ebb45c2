"""A whole run of each cell's harness past its look for a chip, at a size a
test run holds (on the CPU, where the program runs its plain versions): the
program as it is comes out correct, and `correct` comes out false with the
timed path broken underneath by each fault a cell can have and by the
comparison's control. A run with no CUDA device exits non-zero and prints no
result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import cells, run

WALK_FAULTS = ["control", "state_unchanged", "half_left_out", "answer_altered"]
ASSEMBLY_FAULTS = WALK_FAULTS + ["fill_altered", "fill_random", "end_altered", "scaffold_added"]


def _walk_cell():
    cell = cells.find_cell(cells.load_spec(), "hg002.walks-2m")
    cell.config = dict(cell.config, n_nodes=20_000, n_anchors=50)
    cell.mix = dict(cell.mix, params=dict(cell.mix["params"], walks_per_call=4096,
                                          sample_range=6))
    return cell


def _assembly_cell(tmp_path, monkeypatch):
    from benchmark.drivers import assembly

    monkeypatch.setattr(assembly, "INPUT_DIR", str(tmp_path / "inputs"))
    cell = cells.find_cell(cells.with_held(cells.load_spec(), "ecoli.assembly"), "ecoli.assembly")
    # the E. coli preset's repeat and reads, at a twelfth of its genome
    cell.config = dict(cell.config, sim=dict(cell.config["sim"], genome_len=400_000,
                                             n_repeat_copies=6))
    return cell


@pytest.mark.parametrize("fault", [None] + WALK_FAULTS)
def test_walk_cell_catches_each_fault(fault):
    out = run.execute(_walk_cell(), 2**31 + 77, 0.3, False, "cpu", fault=fault)
    assert out["correct"] is (fault is None), out
    assert out["checks"]["walks_differing"]["limit"] == 0
    assert (out["checks"]["walks_differing"]["value"] > 0) is (fault is not None)


@pytest.fixture(scope="module")
def assembly_runs(tmp_path_factory):
    """One set-up, then a window of the program and one of each fault."""
    from benchmark.drivers import assembly

    tmp = tmp_path_factory.mktemp("asm")
    mp = pytest.MonkeyPatch()
    try:
        cell = _assembly_cell(tmp, mp)
        state = assembly.setup(cell, 7, "cpu", False)
        program, out = state.entry, {}
        for fault in [None] + ASSEMBLY_FAULTS:
            state.entry = program
            if fault:
                assembly.FAULTS[fault](state)
            assembly.measure(state, 0.0, False)
            out[fault] = assembly.judge(state)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("fault", [None] + ASSEMBLY_FAULTS)
def test_assembly_cell_catches_each_fault(assembly_runs, fault):
    checks, failed = assembly_runs[fault]
    broken = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert (failed == 0 and not broken) is (fault is None), (fault, checks)
    want = {"control": "misjoins", "state_unchanged": "joins_missing",
            "half_left_out": "contig_errors", "answer_altered": "contig_errors",
            "fill_altered": "gap_error_bp", "fill_random": "join_edits",
            "end_altered": "end_edits", "scaffold_added": "unplaced_bases"}
    if fault:
        assert want[fault] in broken, (fault, checks)


def test_assembly_run_through_execute(tmp_path, monkeypatch):
    out = run.execute(_assembly_cell(tmp_path, monkeypatch), 7, 0.0, False, "cpu")
    assert out["correct"] is True and out["attempted"] == 1
    assert set(out["metrics"]) == {"assembly_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_no_card_no_result(tmp_path):
    """Here torch sees no CUDA device: the run says so and exits non-zero;
    in a directory holding only BENCHMARK.json and benchmark/, too."""
    import shutil

    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "hg002.walks-2m",
           "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=cells.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".inputs", ".cache", "__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert json.load(open(tmp_path / "BENCHMARK.json"))["paths"] == ["benchmark"]

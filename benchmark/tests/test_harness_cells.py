"""The harness is driven by data: BENCHMARK.json as the contract has it, and a
cell, a configuration, a mix and a per-layer metric added by new files and
entries alone, found by a copy of the harness without an edit."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import cells

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("held", [None, "ecoli.assembly"])
def test_benchmark_json_keeps_to_the_contract(held):
    """BENCHMARK.json, and BENCHMARK.json with a held cell's entries put back."""
    spec = cells.load_spec()
    if held:
        spec = cells.with_held(spec, held)
        assert held in {w["name"] for w in spec["workloads"]}
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert os.path.exists(os.path.join(cells.BENCH_DIR, "metrics", m["name"] + ".json"))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        cell = cells.find_cell(spec, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
        assert os.path.exists(os.path.join(cells.BENCH_DIR, "limits", w["name"] + ".json"))
        cells.driver(cell)
        for m in cell.per_layer:
            cells.reader(m["name"])


def test_a_cell_added_by_files_alone(tmp_path):
    """A copy of the harness gains a configuration, a mix, a cell, a reader and
    a per-layer metric by new files and new entries in BENCHMARK.json, and a
    run of the new cell (on the CPU, through the harness's own execute)
    reports the new metric. No file that was there is edited."""
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".inputs", ".cache", "__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (tmp_path / "benchmark").rglob("*") if q.is_file())}
    spec = cells.load_spec()
    b = tmp_path / "benchmark"
    conf = dict(json.load(open(b / "configs" / "hg002.json")), n_nodes=5000, n_anchors=30)
    json.dump(conf, open(b / "configs" / "tiny.json", "w"))
    json.dump({"driver": "walks", "params": {"walks_per_call": 2048, "sampled_calls": 1,
                                             "sample_range": 4, "trace_calls": 2}},
              open(b / "mixes" / "walks-tiny.json", "w"))
    json.dump({"walks_differing": 0}, open(b / "limits" / "tiny.walks-tiny.json", "w"))
    (b / "readers" / "walk_count.py").write_text(
        "def read(observed, scale=1.0):\n    return observed.get('n_calls', 0) * scale\n")
    json.dump({"reader": "stage_seconds", "args": {"stages": ["none"]}},
              open(b / "metrics" / "tiny_stage.json", "w"))
    hg002 = next(c for c in spec["configs"] if c["name"] == "hg002")
    spec["configs"].append(dict(hg002, name="tiny", file="benchmark/configs/tiny.json"))
    spec["workloads"].append({"name": "tiny.walks-tiny", "config": "tiny",
                              "traffic": "walks-tiny", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "walks_per_s")["workloads"].append(
        "tiny.walks-tiny")
    spec["per_layer"].append({"name": "tiny_stage", "unit": "s", "better": "lower",
                              "source": "program_span", "layer": "walks",
                              "moves": "walks_per_s", "workloads": ["tiny.walks-tiny"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    code = """
import json
from benchmark import cells, run
cell = cells.find_cell(cells.load_spec(), "tiny.walks-tiny")
out = run.execute(cell, 12345, 0.2, False, "cpu")
print(json.dumps(dict(out, per_layer=[m["name"] for m in cell.per_layer],
                      where=cells.__file__, reader=cells.reader("tiny_stage")[1])))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["where"].startswith(str(tmp_path))
    assert out["correct"] is True and out["metrics"]["walks_per_s"]["value"] > 0
    assert "tiny_stage" in out["per_layer"] and out["reader"] == {"stages": ["none"]}
    after = {p: open(p, "rb").read() for p in before}
    assert after == before


def test_per_layer_metric_without_workloads_follows_its_end_to_end_metric():
    spec = cells.with_held(cells.load_spec(), "ecoli.assembly")
    spec["per_layer"].append({"name": "x", "unit": "s", "better": "lower",
                              "source": "program_span", "layer": "walks",
                              "moves": "assembly_s"})
    names = {w["name"]: [m["name"] for m in cells.find_cell(spec, w["name"]).per_layer]
             for w in spec["workloads"]}
    assert "x" in names["ecoli.assembly"] and "x" not in names["hg002.walks-2m"]


def test_a_held_cell_is_not_run(capsys):
    """benchmark.run runs only what BENCHMARK.json names."""
    from benchmark import run

    assert run.main(["--workload", "ecoli.assembly", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""

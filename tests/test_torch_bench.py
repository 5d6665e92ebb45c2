"""The port's bench (telomeri_tpu_torch/bench.py) against the reference's root
bench.py and tools/perf_probe.py on the CPU: the same problem (graph arrays,
plan, edge scores), the same synthetic tables, the same oracle rows; and a tiny
run in a fresh interpreter that prints well-formed lines and never loads jax.
Exact everywhere; no time measured here is a device's."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from telomeri_tpu_torch import bench, interop
from test_torch_dist import LAUNCHER_ENV, ROOT

WALK_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_today",
             "oracle_today_walks_per_s", "device_steps_per_s", "batch_walks"}


@pytest.fixture(scope="module")
def ref_bench():
    """The reference's root bench.py as a module (it runs nothing at import)."""
    spec = importlib.util.spec_from_file_location("reference_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problems(ref_bench):
    """build_problem(3) of both benches: (reference's, port's)."""
    return ref_bench.build_problem(3, device_scoring="off"), \
        bench.build_problem(3, device_scoring="off", device="cpu")


def _dataclass_equal(a, b):
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            assert x == y, f.name


def test_build_problem_equals_the_reference_bench(problems):
    (rcfg, redges, rgraph, rplan), (cfg, edges, graph, plan) = problems
    assert interop.config_from_reference(rcfg) == cfg
    assert (cfg.mc_walks_per_end, cfg.max_steps, cfg.device_scoring) == (3, 32, "off")
    assert len(edges) > 50_000 and plan.n_active > 400
    _dataclass_equal(interop.edges_from_reference(redges), edges)    # scores by their bits
    _dataclass_equal(interop.graph_from_reference(rgraph), graph)
    _dataclass_equal(interop.plan_from_reference(rplan), plan)
    assert bench.SIM == dict(genome_len=400_000, repeat_len=5_000, n_repeat_copies=6,
                             read_len_mean=3_000, read_len_sd=500, coverage=20.0,
                             error_rate=0.02, seed=12)


def test_oracle_rows_equal_the_reference_bench(problems, ref_bench, monkeypatch):
    """Both bench_oracle walk the same plan rows, three passes each: recorded
    by a stand-in for walk_oracle in either package."""
    import telomeri_tpu.walk.oracle as ref_oracle
    import telomeri_tpu_torch.walk.oracle as port_oracle

    (rcfg, _, rgraph, rplan), (cfg, _, graph, plan) = problems
    seen = {"ref": [], "port": []}

    def stand_in(key):
        def walk(graph, start, first_edge, mode, uid, max_steps, choice):
            seen[key].append((start, first_edge, mode, uid, max_steps))
            return port_oracle.OracleWalk([start], [], 1, False, -1, 0, 0.0)
        return walk

    monkeypatch.setattr(ref_oracle, "walk_oracle", stand_in("ref"))
    monkeypatch.setattr(port_oracle, "walk_oracle", stand_in("port"))
    ref_bench.bench_oracle(rcfg, rgraph, rplan, max_walks=20)
    walks_per_s, steps_per_s = bench.bench_oracle(cfg, graph, plan, max_walks=20)
    assert seen["port"] == seen["ref"] and len(seen["ref"]) == 3 * 20
    assert steps_per_s == walks_per_s > 0   # the stand-in takes one step a walk
    rows = bench.oracle_rows(plan, 20)
    assert [s[3] for s in seen["port"][:20]] == plan.uid[rows].tolist()
    assert (plan.mode[rows] == 2).all() and plan.active[rows].all()
    assert rows[0] == plan.sections["mc"][0] and len(bench.oracle_rows(plan)) == 36


def test_bench_oracle_measures_the_ports_oracle(problems):
    _, (cfg, _, graph, plan) = problems
    walks_per_s, steps_per_s = bench.bench_oracle(cfg, graph, plan, budget_s=1.0, max_walks=12)
    assert 0 < walks_per_s < steps_per_s   # an MC walk on this graph takes several steps


def _reference_hg002_arrays(ref_bench, monkeypatch, n: int):
    """What the reference's bench_hg002_graph uploads at BENCH_HG002_N=n: its
    GraphTensors' packed table and its plan (captured at plan_to_device)."""
    import telomeri_tpu.walk.engine as ref_engine

    class Captured(Exception):
        pass

    got = {}
    graph_to_device = ref_engine.graph_to_device

    def capture_graph(g, *a, **kw):
        got["wide"] = np.asarray(graph_to_device(g, *a, **kw).wide)
        return graph_to_device(g, *a, **kw)

    def capture_plan(p, *a, **kw):
        got["plan"] = p
        raise Captured

    monkeypatch.setenv("BENCH_HG002_N", str(n))
    monkeypatch.setattr(ref_engine, "graph_to_device", capture_graph)
    monkeypatch.setattr(ref_engine, "plan_to_device", capture_plan)
    with pytest.raises(Captured):
        ref_bench.bench_hg002_graph()
    return got["wide"], got["plan"]


def test_synthetic_table_equals_the_reference_hg002_generator(ref_bench, monkeypatch):
    n = 8192
    want_wide, want_plan = _reference_hg002_arrays(ref_bench, monkeypatch, n)
    rng = np.random.default_rng(0)
    wide = bench.synthetic_table(rng, n)
    assert wide.dtype == np.int32 and wide.shape == (n, 6 * 64)
    np.testing.assert_array_equal(wide, want_wide)
    pd = bench.synthetic_plan(rng, bench.SYNTH_WALKS, "cpu")   # the next draws of the same rng
    for f in ("start", "first_edge", "mode", "uid", "active"):
        np.testing.assert_array_equal(getattr(pd, f).numpy(), getattr(want_plan, f), err_msg=f)
    assert (bench.HG002_N, bench.SYNTH_K, bench.SYNTH_WALKS, bench.SYNTH_STEPS) == \
        (6_291_456, 64, 49_152, 32)
    assert bench.HG002_N * 6 * 64 * 4 == 9_663_676_416   # the 9.66 GB table


def test_synthetic_table_equals_the_reference_sweep_generator():
    """tools/perf_probe.py probe_walks builds its table at a fixed N of 2**20;
    its generator lines (:104-114, :119-123), transcribed, at a small N."""
    from telomeri_tpu.graph.tensorize import GraphTensors
    from telomeri_tpu.walk.engine import graph_to_device

    n, k, n_anchors = 6000, 64, 2000
    rng = np.random.default_rng(0)
    deg = rng.integers(4, k + 1, n).astype(np.int32)
    mask = np.arange(k, dtype=np.int32)[None, :] < deg[:, None]
    g = GraphTensors(
        nbr=np.where(mask, rng.integers(2 * n_anchors, n, (n, k)).astype(np.int32), -1),
        es=(es := np.where(mask, rng.uniform(100, 5000, (n, k)), 0).astype(np.float32)),
        os_=es.copy(),
        adv=np.where(mask, rng.integers(100, 3000, (n, k)).astype(np.int32), 0),
        eid=np.where(mask, np.arange(n * k, dtype=np.int64).reshape(n, k) % (2**31 - 1),
                     -1).astype(np.int32),
        deg=deg, seq_len=np.full(n // 2, 20000, np.int32), n_anchors=n_anchors)
    want = np.asarray(graph_to_device(g).wide)
    starts = [rng.integers(0, 2 * n_anchors, w).astype(np.int32) for w in (512, 1024)]

    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(bench.synthetic_table(rng, n), want)
    for w, start in zip((512, 1024), starts):   # one plan per width, drawn in turn
        pd = bench.synthetic_plan(rng, w, "cpu")
        np.testing.assert_array_equal(pd.start.numpy(), start)
        np.testing.assert_array_equal(pd.uid.numpy(), np.arange(w))
    assert (bench.SWEEP_N, bench.SWEEP_WIDTHS) == \
        (1_048_576, (49_152, 98_304, 196_608, 393_216, 786_432))


def test_synthetic_table_narrower_than_its_lane_width():
    """K below the lane width: the slots past K are pack_wide's pads."""
    from telomeri_tpu_torch.kernels.walk_table import pack_wide

    n, k = 4200, 40
    wide = bench.synthetic_table(np.random.default_rng(3), n, k=k)
    h = wide.shape[1] // 6
    assert h == 64
    block = lambda b: wide[:, b * h:b * h + k]
    again = pack_wide(block(0), block(1), block(2), block(3), block(4).view(np.float32),
                      block(5).view(np.float32), h)
    np.testing.assert_array_equal(wide, again)
    assert (wide[:, h + k:2 * h] == wide[:, h + k - 1:h + k]).all()


def test_hg002_graph_and_sweep_run_small_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench, "SYNTH_WALKS", 256)
    line = bench.bench_hg002_graph("cpu", n=4500)
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert line["metric"] == "hg002_scale_walks_per_s_per_gpu" and line["unit"] == "walks/s"
    assert line["nodes"] == 4500 and line["batch_walks"] == 256 and line["device"] == "cpu"
    assert line["vs_baseline"] == line["table_gib"] == round(4500 * 384 * 4 / 2**30, 2)
    assert line["value"] > 0 and line["device_steps_per_s"] >= line["value"]
    rows = bench.bench_sweep("cpu", n=4500, widths=(128, 256))
    out = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert out == rows and [r["batch_walks"] for r in rows] == [128, 256]
    assert all(r["metric"] == "sweep_walks_per_s_per_gpu" and r["value"] > 0 for r in rows)


def test_hg002_graph_refuses_a_host_without_the_memory(monkeypatch):
    free = bench.host_memory_available()
    assert free is None or free > 0
    monkeypatch.setattr(bench, "host_memory_available", lambda: 2**30)
    with pytest.raises(MemoryError, match="lower BENCH_HG002_N"):
        bench.bench_hg002_graph("cpu", n=bench.HG002_N)


def test_bench_walks_and_split(problems):
    _, (cfg, _, graph, plan) = problems
    walks_per_s, steps_per_s, split = bench.bench_walks(cfg, graph, plan, 1, "cpu")
    assert 0 < walks_per_s < steps_per_s
    assert split["greedy_walks"] + split["mc_walks"] == len(plan)
    for k in ("greedy_ms", "scan_ms", "resolve_ms", "whole_ms"):
        assert split[k] > 0, k
    assert "resolve_peak_mb" not in split   # a device reading: not made on the CPU


def test_bench_scoring_tiles_the_edges(problems):
    _, (_, edges, _, _) = problems
    s = bench.bench_scoring(edges, 1, "cpu", rows=3 * len(edges) + 5)
    assert s["rows"] == 3 * len(edges) and s["overlaps_per_s"] > 0 and s["host_overlaps_per_s"] > 0
    assert bench.bench_scoring(edges, 1, "cpu", rows=10)["rows"] == len(edges)


def test_timed_ms_runs_the_burst():
    calls = []
    assert bench.timed_ms(lambda: calls.append(1), 7, torch.device("cpu")) >= 0
    assert len(calls) == 7


def _run_bench(tmp_path, env: dict, args=("--device", "cpu"), timeout=300):
    code = ("import sys, runpy\n"
            "try:\n"
            "    runpy.run_module('telomeri_tpu_torch.bench', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code or 0\n"
            "loaded = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'telomeri_tpu'))\n"
            "print('LOADED', loaded)\n"
            "sys.exit(rc)\n")
    full = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV
            and not k.startswith("BENCH_")}
    full.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", TELOMERI_CACHE=str(tmp_path / "cache"),
                **env)
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          env=full, timeout=timeout, cwd=str(tmp_path))


def test_tiny_bench_run_prints_well_formed_lines_without_jax(tmp_path):
    proc = _run_bench(tmp_path, dict(BENCH_MC_WALKS="2", BENCH_PEAK_MC_WALKS="4",
                                     BENCH_REPEATS="1", BENCH_SCORING_ROWS="200000"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    *lines, loaded = proc.stdout.strip().splitlines()
    assert loaded == "LOADED []"
    small, peak, scoring = (json.loads(ln) for ln in lines)
    for line in (small, peak):
        assert WALK_KEYS <= set(line) and line["metric"] == "mc_walks_per_s_per_gpu"
        assert line["unit"] == "walks/s" and line["device"] == "cpu" and line["value"] > 0
        # the baseline is the oracle of this run, steps/s over steps/s
        assert line["vs_baseline"] == round(
            line["device_steps_per_s"] / line["oracle_today_steps_per_s"], 2)
    assert small["batch_walks"] < peak["batch_walks"]
    assert small["oracle_today_walks_per_s"] == peak["oracle_today_walks_per_s"]
    assert scoring["metric"] == "overlaps_scored_per_s" and scoring["unit"] == "overlaps/s"
    assert 100_000 < scoring["rows"] <= 200_000 and scoring["value"] > 0
    assert "oracle baseline" in proc.stderr and "walk stage split" in proc.stderr


def test_bench_runs_on_the_cpu_only_when_asked(tmp_path):
    """Without --device cpu and without a card it exits non-zero and prints no line."""
    proc = _run_bench(tmp_path, dict(BENCH_MC_WALKS="2", BENCH_PEAK_MC_WALKS="0"), args=())
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert [ln for ln in proc.stdout.splitlines() if ln.startswith("{")] == []
    proc = _run_bench(tmp_path, dict(BENCH_SCALE="nonsense"))
    assert proc.returncode != 0 and "BENCH_SCALE" in proc.stderr


def test_peak_batch_left_out_and_scaling_on_one_device(tmp_path):
    proc = _run_bench(tmp_path, dict(BENCH_MC_WALKS="2", BENCH_PEAK_MC_WALKS="0",
                                     BENCH_REPEATS="1", BENCH_SCALING="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [ln["metric"] for ln in lines] == ["mc_walks_per_s_per_gpu"]
    assert "scaling: only 1 device, skipping" in proc.stderr
    assert "peak batch left out" in proc.stderr


def test_bench_scaling_worlds_on_gloo(tmp_path, monkeypatch, capfd):
    """The scaling sweep's worker on worlds of 1 and 2 CPU processes."""
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TELOMERI_CACHE", str(tmp_path / "cache"))
    assert bench.bench_scaling(2, 1, "cpu", worlds=(1, 2)) == [1, 2]
    out = capfd.readouterr()
    lines = [json.loads(ln) for ln in out.out.splitlines() if ln.startswith("{")]
    assert [ln["devices"] for ln in lines] == [1, 2]
    assert all(ln["metric"] == "walk_stage_walks_per_s" and ln["value"] > 0 for ln in lines)
    assert lines[0]["batch_walks"] == lines[1]["batch_walks"]
    assert bench.bench_scaling(2, 1, "cpu") == []   # one device: nothing to scale over

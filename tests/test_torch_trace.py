"""--trace and TELOMERI_TRACE in the port: a torch.profiler Chrome trace of the
whole run, written on CPU, one file per process, and nothing without either;
the program's spans (utils/profiling.py span) in it, and its counters in
metrics.json."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.cli.main import main as cli_main
from telomeri_tpu_torch.kernels import launch_counts, reset_launch_counts
from telomeri_tpu_torch.pipeline import run_pipeline
from telomeri_tpu_torch.utils import profiling
from telomeri_tpu_torch.utils.logging import Metrics
from telomeri_tpu_torch.utils.profiling import (count, counters, counters_since, maybe_trace,
                                                reset_counters, span)
from telomeri_tpu_torch.walk import engine

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")


def _trace_events(d) -> list:
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("run.rank0.") \
        and files[0].endswith(".pt.trace.json"), files
    with open(os.path.join(d, files[0])) as f:
        return json.load(f)["traceEvents"]


def _lambda_cfg(**kw) -> ScaffoldConfig:
    with open(os.path.join(LAMBDA, "config.json")) as f:
        return ScaffoldConfig(**dict(json.load(f), **kw))


def _cli_args(out: str) -> list:
    args = ["scaffold", "--device", "cpu", "--config", os.path.join(LAMBDA, "config.json"),
            "--out", out]
    for flag, name in zip(("--contigs", "--reads", "--paf-read-contig", "--paf-read-read"),
                          INPUTS):
        args += [flag, os.path.join(LAMBDA, name)]
    return args


def _golden() -> bytes:
    with open(os.path.join(LAMBDA, "golden_scaffolds.fa"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def lambda_run():
    """The lambda toy through the pipeline once (no rescue round): its graph
    and plan, for the engine's own entry points."""
    return run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], None,
                        _lambda_cfg(rescue_rounds=0), device="cpu")


def _program_spans(events) -> list:
    """(name, start, end) of the program's spans, the prefix taken off."""
    return [(e.name[len(profiling.PREFIX):], e.time_range.start, e.time_range.end)
            for e in events if e.name.startswith(profiling.PREFIX)]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_trace_flag_writes_a_trace_on_cpu(tmp_path):
    out, tr = str(tmp_path / "x.fa"), str(tmp_path / "trace")
    rc = cli_main(_cli_args(out) + ["--trace", tr])
    assert rc == 0
    names = {e.get("name") for e in _trace_events(tr)}
    assert "aten::index" in names    # the walk scans' row gathers were traced
    with open(out, "rb") as a, open(os.path.join(LAMBDA, "golden_scaffolds.fa"), "rb") as b:
        assert a.read() == b.read()


def test_trace_env_var(tmp_path, monkeypatch):
    tr = str(tmp_path / "env_trace")
    monkeypatch.setenv("TELOMERI_TRACE", tr)
    run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], None, _lambda_cfg(), device="cpu")
    assert _trace_events(tr)


def test_no_trace_without_dir(monkeypatch):
    monkeypatch.delenv("TELOMERI_TRACE", raising=False)
    assert isinstance(maybe_trace(None), contextlib.nullcontext)


def test_no_span_is_made_without_a_profiler(lambda_run, monkeypatch):
    """With no profiler running a span records nothing: neither the program's
    range nor torch.profiler.record_function is ever constructed."""
    made = []

    def counting(*a, **k):
        made.append(a)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "_Range", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    gd = engine.graph_to_device(lambda_run.graph, "cpu")
    sections = engine.prepare_plan_sections(lambda_run.plan, "cpu")
    engine.run_walks_prepared(gd, sections, 0, n_anchors=lambda_run.graph.n_anchors,
                              max_steps=24)
    with span("any", id=1):
        pass
    assert made == []
    # the same patch does see a span while a profiler runs
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("seen"):
            pass
    assert made == [("telomeri:seen", (), {})]


def test_dispatch_spans_nest_and_stay_off_the_device_timeline(lambda_run):
    """Under torch.profiler one run_walks_prepared on lambda is a
    telomeri:walk.dispatch span with a walk.section span for each section
    inside it. The spans are FUNCTION-scope ranges ("cpu_op"), not
    record_function's USER scope, which the profiler would mirror onto the
    device's timeline as annotations over the kernels."""
    from torch.profiler import ProfilerActivity, profile

    gd = engine.graph_to_device(lambda_run.graph, "cpu")
    sections = engine.prepare_plan_sections(lambda_run.plan, "cpu")
    assert [k for k, _ in sections] == ["greedy", "mc"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run_walks_prepared(gd, sections, 0, n_anchors=lambda_run.graph.n_anchors,
                                  max_steps=24)
    events = prof.events()
    spans = _program_spans(events)
    dispatch = [s for s in spans if s[0] == "walk.dispatch"]
    sec = [s for s in spans if s[0] == "walk.section"]
    concat = [s for s in spans if s[0] == "walk.concat"]
    assert len(dispatch) == 1 and len(sec) == 2 and len(concat) == 1
    assert all(_inside(s, dispatch[0]) for s in sec + concat)
    scopes = {e.scope for e in events if e.name.startswith(profiling.PREFIX)}
    assert scopes == {0}, scopes   # at::RecordScope::FUNCTION


def test_chunked_dispatch_names_each_chunk_and_its_download(lambda_run):
    """run_walks_chunked: one walk.chunk span a chunk, each holding its own
    walk.dispatch and walk.download; the counters count one dispatch a chunk."""
    from torch.profiler import ProfilerActivity, profile

    g, plan = lambda_run.graph, lambda_run.plan
    gd = engine.graph_to_device(g, "cpu")
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = engine.run_walks_chunked(gd, plan, 0, n_anchors=g.n_anchors, max_steps=24,
                                       max_batch=128)
    added = counters_since(before)
    spans = _program_spans(prof.events())
    chunks = [s for s in spans if s[0] == "walk.chunk"]
    greedy, mc = (hi - lo for lo, hi in (plan.sections[k] for k in ("greedy", "mc")))
    n_chunks = -(-greedy // 128) + -(-mc // 128)
    assert len(chunks) == n_chunks == added["walk.dispatches"]
    for name in ("walk.dispatch", "walk.download", "plan.upload"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == n_chunks
        assert all(any(_inside(s, c) for c in chunks) for s in inner)
    # a section of several chunks pads its last one to the whole chunk
    rows = sum(-(-n // 128) * 128 if n > 128 else n for n in (greedy, mc))
    assert added["walk.walks"] == rows
    assert added["walk.steps_scanned"] == rows * 24
    assert added.get("bytes.h2d", 0) == 0 and added.get("bytes.d2h", 0) == 0   # on the host
    assert len(res.steps) == len(plan)


def test_whole_run_trace_names_every_stage(tmp_path):
    """run_pipeline under a trace directory: one run.rank0.* file for the whole
    run, a telomeri:stage.<name> span for every stage that Metrics timed, the
    walk stage's dispatch and the consensus parts inside their stages, and the
    FASTA byte for byte the golden one."""
    tr, out = str(tmp_path / "trace"), str(tmp_path / "x.fa")
    metrics = Metrics()
    res = run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], out, _lambda_cfg(), metrics,
                       trace_dir=tr, device="cpu")
    with open(out, "rb") as f:
        assert f.read() == _golden()
    events = [e for e in _trace_events(tr) if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e["name"].startswith(profiling.PREFIX):
            spans.setdefault(e["name"][len(profiling.PREFIX):], []).append(
                (e["ts"], e["ts"] + e["dur"], e.get("args", {})))
    assert metrics.timings and {f"stage.{k}" for k in metrics.timings} <= set(spans)

    def within(name, stage):
        (a, b, _), = spans[stage]
        return all(a <= s and e <= b for s, e, _ in spans[name])

    assert within("walk.dispatch", "stage.run_walks")
    assert within("walk.pack", "stage.run_walks") and within("walk.upload", "stage.run_walks")
    for part in ("consensus.upload", "consensus.summarize", "consensus.select",
                 "consensus.compress", "walk.download"):
        assert any(s >= spans["stage.consensus"][0][0] for s, _, _ in spans[part]), part
    # the ids ride along as args: the base dispatch's walks and steps
    args = spans["walk.dispatch"][0][2]
    assert args["W"] == len(res.plan) and args["S"] == 24
    assert {a["kind"] for _, _, a in spans["walk.section"]} == {"greedy", "mc"}


def test_metrics_json_counters_agree_with_what_they_count(tmp_path):
    """metrics.json's counters: launch.* as kernels.launch_counts() reads them,
    one dispatch of len(plan) walks, W x S steps scanned, and the steps that
    the records took (no rescue round, so the base dispatch is all)."""
    out = str(tmp_path / "x.fa")
    reset_launch_counts()
    metrics = Metrics()
    res = run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], out,
                       _lambda_cfg(rescue_rounds=0), metrics, device="cpu")
    c = metrics.counters
    assert {k: c["launch." + k] for k in launch_counts()} == launch_counts()
    assert set(launch_counts().values()) == {0}   # CPU tensors launch no kernel
    assert c["walk.dispatches"] == 1
    assert c["walk.walks"] == len(res.plan)
    assert c["walk.steps_scanned"] == len(res.plan) * 24
    assert c["walk.steps_taken"] == int(np.asarray(res.walks.steps).sum()) > 0
    assert c["walk.steps_taken"] < c["walk.steps_scanned"]
    assert c.get("bytes.h2d", 0) == 0 == c.get("bytes.d2h", 0)
    # the CLI writes them under "counters"
    assert cli_main(_cli_args(out)) == 0
    with open(out + ".metrics.json") as f:
        written = json.load(f)["counters"]
    assert written["walk.dispatches"] >= 1 and "launch.walk_scan" in written


def test_rescue_round_counts_its_dispatch_and_steps(lambda_run):
    """A rescue round (every walkable end free) is one more walk dispatch, and
    the steps its records took are counted from them."""
    from telomeri_tpu_torch.walk.rescue import build_rescue_plan, free_walkable_ends, \
        run_rescue_round

    g = lambda_run.graph
    cfg = _lambda_cfg(rescue_walks_per_end=16)
    plan, _ = build_rescue_plan(free_walkable_ends(g, []), cfg)
    before = counters()
    run_rescue_round(g, cfg, [], 0, device="cpu")
    added = counters_since(before)
    assert added["walk.dispatches"] == 1 and added["walk.walks"] == len(plan)
    assert 0 < added["walk.steps_taken"] <= added["walk.steps_scanned"] == len(plan) * 24


def test_counter_registry():
    """count adds and returns the new value; reset_counters zeroes a prefix and
    keeps the names; counters_since gives what was added; launch_counts keeps
    its kernels and zeroes with reset_launch_counts."""
    reset_counters("test.")
    assert count("test.a") == 1 and count("test.a", 4) == 5
    before = counters()
    count("test.b", 2)
    count("test.a")
    added = counters_since(before)
    assert added["test.a"] == 1 and added["test.b"] == 2
    reset_counters("test.")
    assert counters()["test.a"] == 0 == counters()["test.b"]
    assert list(launch_counts()) == ["walk_scan", "resolve_events", "greedy_scan",
                                     "score_os_es2", "score_overlaps"]
    count("launch.walk_scan", 3)
    assert launch_counts()["walk_scan"] >= 3
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_copies_are_counted_only_across_the_host_boundary():
    """bytes.h2d / bytes.d2h count a copy between the host and a device, and no
    copy that stays on one side."""
    a = np.zeros(10, np.int32)
    before = counters()
    profiling.count_copy([a, a], "cpu", "cpu")
    profiling.count_copy([a], "cpu", torch.device("meta"))
    profiling.count_copy([a, a], "meta", "cpu")
    added = counters_since(before)
    assert added.get("bytes.h2d") == 40 and added.get("bytes.d2h") == 80

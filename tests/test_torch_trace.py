"""--trace and TELOMERI_TRACE in the port: a torch.profiler Chrome trace of the
walk stage, written on CPU, one file per process, and nothing without either."""

import contextlib
import json
import os

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.cli.main import main as cli_main
from telomeri_tpu_torch.pipeline import run_pipeline
from telomeri_tpu_torch.utils.profiling import maybe_trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
INPUTS = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")


def _trace_events(d) -> list:
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("walks.rank0.") \
        and files[0].endswith(".pt.trace.json"), files
    with open(os.path.join(d, files[0])) as f:
        return json.load(f)["traceEvents"]


def test_trace_flag_writes_a_trace_on_cpu(tmp_path):
    out, tr = str(tmp_path / "x.fa"), str(tmp_path / "trace")
    rc = cli_main(["scaffold", "--device", "cpu",
                   "--config", os.path.join(LAMBDA, "config.json"),
                   "--contigs", os.path.join(LAMBDA, "contigs.fa"),
                   "--reads", os.path.join(LAMBDA, "reads.fa"),
                   "--paf-read-contig", os.path.join(LAMBDA, "read2contig.paf"),
                   "--paf-read-read", os.path.join(LAMBDA, "read2read.paf"),
                   "--trace", tr, "--out", out])
    assert rc == 0
    names = {e.get("name") for e in _trace_events(tr)}
    assert "aten::index" in names    # the walk scans' row gathers were traced
    with open(out, "rb") as a, open(os.path.join(LAMBDA, "golden_scaffolds.fa"), "rb") as b:
        assert a.read() == b.read()


def test_trace_env_var(tmp_path, monkeypatch):
    tr = str(tmp_path / "env_trace")
    monkeypatch.setenv("TELOMERI_TRACE", tr)
    with open(os.path.join(LAMBDA, "config.json")) as f:
        cfg = ScaffoldConfig(**json.load(f))
    run_pipeline(*[os.path.join(LAMBDA, f) for f in INPUTS], None, cfg, device="cpu")
    assert _trace_events(tr)


def test_no_trace_without_dir(monkeypatch):
    monkeypatch.delenv("TELOMERI_TRACE", raising=False)
    assert isinstance(maybe_trace(None), contextlib.nullcontext)

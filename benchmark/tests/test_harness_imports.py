"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
imports nothing of the program. Names are compared by their whole top-level
part, so telomeri_tpu_torch is not taken for telomeri_tpu."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import cells, run

FORBIDDEN = {"jax", "jaxlib", "flax", "telomeri_tpu"}


def _modules() -> list[str]:
    out = []
    for path in sorted(glob.glob(os.path.join(cells.BENCH_DIR, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, cells.ROOT)[:-3].replace(os.sep, ".")
        if ".tests." not in rel:
            out.append(rel[:-9] if rel.endswith(".__init__") else rel)
    return out


def test_every_module_and_a_run_load_no_jax():
    """Every module of the harness, the program's pipeline, and a small walk
    run through the harness on the CPU, in one fresh interpreter."""
    mods = _modules()
    assert {"benchmark.run", "benchmark.drivers.walks", "benchmark.reference.walks"} <= set(mods)
    code = f"""
import importlib, json, sys
for m in {mods!r}:
    importlib.import_module(m)
import telomeri_tpu_torch.pipeline
from benchmark import cells, run
cell = cells.find_cell(cells.load_spec(), "hg002.walks-2m")
cell.config = dict(cell.config, n_nodes=4000, n_anchors=20)
cell.mix = dict(cell.mix, params=dict(cell.mix["params"], walks_per_call=512, sample_range=3))
assert run.execute(cell, 5, 0.1, False, "cpu")["correct"]
print(json.dumps(sorted(sys.modules)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in loaded} & FORBIDDEN
    assert "telomeri_tpu_torch" in {m.split(".")[0] for m in loaded}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "telomeri_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "telomeri_tpu.x", sys)
    assert run.forbidden_modules() == ["telomeri_tpu.x"]


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_and_generators_import_nothing_of_the_program():
    paths = glob.glob(os.path.join(cells.BENCH_DIR, "reference", "*.py"))
    paths += glob.glob(os.path.join(cells.BENCH_DIR, "gen", "*.py"))
    paths.append(os.path.join(cells.BENCH_DIR, "roofline.py"))
    for path in paths:
        assert not _imports(path) & (FORBIDDEN | {"telomeri_tpu_torch"}), path
    code = """
import json, sys
import benchmark.reference.walks, benchmark.reference.assembly, benchmark.gen.sim
import benchmark.gen.walk_table, benchmark.roofline
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not set(json.loads(proc.stdout)) & (FORBIDDEN | {"telomeri_tpu_torch"})

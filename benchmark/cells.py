"""Find a cell's parts by the names in BENCHMARK.json, with no table in code.

  configuration   configs[].file, the JSON that BENCHMARK.json names
  traffic mix     mixes/<traffic>.json: {"driver": <module>, "params": {...}}
  driver          drivers/<module>.py: setup / measure / release / judge
  limits          limits/<cell>.json: {<number compared>: <limit>}
  per-layer metric  metrics/<metric name>.json: {"reader": <module>, "args": {...}}
  reader          readers/<module>.py: read(observed, **args) -> number or None
  held cell       held/<cell>.json: the BENCHMARK.json entries of a cell kept out
                  of it, which benchmark.control and the tests still run

A later change adds a configuration, a mix, a cell or a metric by adding such
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: str
    mix: dict
    chips: int
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def with_held(spec: dict, workload: str) -> dict:
    """`spec` with the entries of held/<workload>.json added, where
    BENCHMARK.json does not name that cell."""
    path = os.path.join(BENCH_DIR, "held", workload + ".json")
    if any(w["name"] == workload for w in spec["workloads"]) or not os.path.exists(path):
        return spec
    with open(path) as f:
        extra = json.load(f)
    return {k: v + extra[k] if k in extra else v for k, v in spec.items()}


def _in_cell(metric: dict, cell: str) -> bool | None:
    """True / False where the metric lists its cells, None where it does not."""
    return cell in metric["workloads"] if "workloads" in metric else None


def find_cell(spec: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload`, with its configuration and mix read from
    their files and the metrics that it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "mixes", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _in_cell(m, workload) is not False]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (_in_cell(m, workload) if "workloads" in m else m["moves"] in names)]
    return Cell(name=workload, config_name=w["config"], config=config, traffic=w["traffic"],
                mix=mix, chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


def driver(cell: Cell):
    """The module that runs the cell's mix."""
    return importlib.import_module(f"{__package__}.drivers.{cell.mix['driver']}")


def limits(cell: Cell) -> dict:
    """Each number the cell's judgement compares, with its limit."""
    with open(os.path.join(BENCH_DIR, "limits", cell.name + ".json")) as f:
        return json.load(f)


def reader(metric_name: str):
    """(read function, its arguments) of a per-layer metric."""
    with open(os.path.join(BENCH_DIR, "metrics", metric_name + ".json")) as f:
        entry = json.load(f)
    mod = importlib.import_module(f"{__package__}.readers.{entry['reader']}")
    return mod.read, entry.get("args", {})

"""Stage artifacts: the port of telomeri_tpu/io/artifacts.py.

The tensorized graph after ingest and the walk table after the device phase are
saved at their stage boundaries, so a rerun skips the expensive stages
(`--save-graph/--graph`, `--save-walks/--walks`).

Format: the reference's, unchanged: one .npz per artifact with a JSON header
carrying the producing ScaffoldConfig, the kind and a schema version, so a graph
or walks artifact written by either package resumes in the other. Loading
verifies the schema version and warns on a config mismatch (the caller decides
whether that matters). load_walks builds this package's WalkResult of host
numpy records.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.io.geometry import EdgeSoA
from telomeri_tpu_torch.utils.logging import log
from telomeri_tpu_torch.walk.engine import WalkResult
from telomeri_tpu_torch.walk.plan import WalkPlan

SCHEMA = 1

_EDGE_FIELDS = ("src", "dst", "os_", "es", "adv", "ue", "ve", "row",
                "nm", "bl", "ol1", "ol2", "oh1", "oh2", "el")
_GRAPH_FIELDS = ("nbr", "es", "os_", "adv", "eid", "deg", "seq_len",
                 "edge_es", "edge_adv",
                 # the precomputed MC sampling cumsum: persisted so a resumed graph
                 # is byte-equal to the freshly-built one (its int32 overflow guard
                 # runs at tensorize time only); absent in older artifacts, where
                 # the engine recomputes it
                 "cumw",
                 # round 4: split-mapped (chimera-suspect) flags for the cut-read
                 # gate; absent in older artifacts -> gate falls back conservative
                 "split_read")
_PLAN_FIELDS = ("start", "first_edge", "mode", "uid", "active")
_WALK_FIELDS = ("nodes", "eids", "steps", "success", "terminal", "path_len",
                "score_sum")


def _header(cfg: ScaffoldConfig, kind: str) -> str:
    return json.dumps({
        "schema": SCHEMA, "kind": kind,
        "config": dataclasses.asdict(cfg),
    })


def _check_header(raw, kind: str, cfg: ScaffoldConfig | None) -> dict:
    h = json.loads(str(raw))
    if h.get("schema") != SCHEMA or h.get("kind") != kind:
        raise ValueError(
            f"artifact is {h.get('kind')!r} schema {h.get('schema')}, "
            f"expected {kind!r} schema {SCHEMA}")
    if cfg is not None and h["config"] != dataclasses.asdict(cfg):
        cur = dataclasses.asdict(cfg)
        diff = {k: (h["config"].get(k), cur.get(k))
                for k in sorted(set(h["config"]) | set(cur))
                if h["config"].get(k) != cur.get(k)}
        log.warning("artifact config differs from current config "
                    "(saved, current): %s", diff)
    return h


def save_graph(path: str, edges: EdgeSoA, graph: GraphTensors,
               cfg: ScaffoldConfig) -> None:
    np.savez_compressed(
        path,
        header=_header(cfg, "graph"),
        n_anchors=np.int64(graph.n_anchors),
        n_truncated_edges=np.int64(graph.n_truncated_edges),
        stats=json.dumps(graph.stats),
        **{f"edge_{f}": getattr(edges, f) for f in _EDGE_FIELDS},
        **{f"graph_{f}": getattr(graph, f) for f in _GRAPH_FIELDS
           if getattr(graph, f) is not None},
    )


def load_graph(path: str, cfg: ScaffoldConfig | None = None
               ) -> tuple[EdgeSoA, GraphTensors]:
    z = np.load(path, allow_pickle=False)
    _check_header(z["header"], "graph", cfg)
    edges = EdgeSoA(**{f: z[f"edge_{f}"] for f in _EDGE_FIELDS})
    kw = {f: z[f"graph_{f}"] for f in _GRAPH_FIELDS if f"graph_{f}" in z}
    graph = GraphTensors(
        n_anchors=int(z["n_anchors"]),
        n_truncated_edges=int(z["n_truncated_edges"]),
        stats=json.loads(str(z["stats"])), **kw,
    )
    return edges, graph


def save_walks(path: str, plan: WalkPlan, walks, cfg: ScaffoldConfig) -> None:
    walks = walks.to_numpy() if hasattr(walks, "to_numpy") else walks
    np.savez_compressed(
        path,
        header=_header(cfg, "walks"),
        **{f"plan_{f}": getattr(plan, f) for f in _PLAN_FIELDS},
        **{f"walk_{f}": np.asarray(getattr(walks, f)) for f in _WALK_FIELDS},
    )


def load_walks(path: str, cfg: ScaffoldConfig | None = None
               ) -> tuple[WalkPlan, WalkResult]:
    """(plan, host numpy records) of a walks artifact; raises ValueError on a
    wrong kind or schema, warns where its config differs from cfg."""
    with np.load(path, allow_pickle=False) as z:
        _check_header(z["header"], "walks", cfg)
        plan = WalkPlan(**{f: z[f"plan_{f}"] for f in _PLAN_FIELDS})
        walks = WalkResult(**{f: z[f"walk_{f}"] for f in _WALK_FIELDS})
    return plan, walks

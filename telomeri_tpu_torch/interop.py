"""Carry the reference's objects into the port (the analogue of loading weights).

The two packages define the same classes twice, so an object of the JAX package
is not an instance of this package's class. Each converter reads its argument
through its fields, as numpy arrays and plain values (np.asarray of a jax array),
and never imports the reference: the JAX package's packed walk table, walk plan
and walk records become this package's tensors, and its host dataclasses
(ScaffoldConfig, EdgeSoA, GraphTensors, WalkPlan, PafRecords) become this
package's dataclasses of the same name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.io.geometry import EdgeSoA
from telomeri_tpu_torch.io.paf import PafRecords
from telomeri_tpu_torch.kernels.walk_table import GraphDev, table_h
from telomeri_tpu_torch.walk.engine import PlanDev, WalkResult
from telomeri_tpu_torch.walk.plan import WalkPlan


def _from_fields(cls, obj):
    """cls(**fields of obj), each numpy field copied; obj has cls's field names."""
    def value(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, dict):
            return {k: value(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(value(x) for x in v)
        return np.array(v)
    return cls(**{f.name: value(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def config_from_reference(cfg) -> ScaffoldConfig:
    """The reference's ScaffoldConfig as this package's (same fields, same JSON)."""
    return _from_fields(ScaffoldConfig, cfg)


def edges_from_reference(edges) -> EdgeSoA:
    return _from_fields(EdgeSoA, edges)


def graph_from_reference(graph) -> GraphTensors:
    return _from_fields(GraphTensors, graph)


def plan_from_reference(plan) -> WalkPlan:
    return _from_fields(WalkPlan, plan)


def paf_from_reference(paf) -> PafRecords:
    return _from_fields(PafRecords, paf)


def graph_dev_from_numpy(wide, device="cpu") -> GraphDev:
    """The reference's GraphDev.wide, (N, 6H) int32, as the port's GraphDev."""
    wide = torch.from_numpy(np.array(wide))   # a writable copy
    table_h(wide)
    return GraphDev(wide=wide.to(device))


def plan_dev_from_numpy(plan, device="cpu") -> PlanDev:
    """Anything with start / first_edge / mode / uid / active arrays (the
    reference's PlanDev or WalkPlan) as the port's PlanDev."""
    put = lambda a, dt: torch.from_numpy(np.array(a)).to(device=device, dtype=dt)
    return PlanDev(start=put(plan.start, torch.int32),
                   first_edge=put(plan.first_edge, torch.int32),
                   mode=put(plan.mode, torch.int32), uid=put(plan.uid, torch.int32),
                   active=put(plan.active, torch.bool))


def walk_result_to_numpy(res) -> WalkResult:
    """Walk records of either package as the port's WalkResult of numpy arrays."""
    return WalkResult(*[a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                        for a in res])

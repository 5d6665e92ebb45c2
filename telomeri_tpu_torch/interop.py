"""Carry the reference's device tables into the port (the analogue of loading
weights): the JAX package's packed walk table, walk plan and walk records arrive
as numpy arrays (np.asarray of its jax arrays) and become this package's tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from telomeri_tpu_torch.walk.engine import GraphDev, PlanDev, WalkResult


def graph_dev_from_numpy(wide, device="cpu") -> GraphDev:
    """The reference's GraphDev.wide, (N, 6H) int32, as the port's GraphDev."""
    wide = np.asarray(wide)
    if wide.ndim != 2 or wide.shape[1] % 6 or wide.dtype != np.int32:
        raise ValueError(f"expected an (N, 6H) int32 table, got {wide.shape} {wide.dtype}")
    return GraphDev(wide=torch.from_numpy(np.array(wide)).to(device))   # a writable copy


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

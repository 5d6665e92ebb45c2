"""Stage artifacts: the port of telomeri_tpu/io/artifacts.py.

The files are the reference's (one .npz each, a JSON header with the schema
version, the kind and the producing ScaffoldConfig), so a graph or walks
artifact written by either package resumes in the other. save_graph, load_graph
and save_walks are the reference's own numpy code; load_walks builds this
package's WalkResult (host numpy records) where the reference builds its jax
engine's.
"""

from __future__ import annotations

import numpy as np

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.io.artifacts import (  # noqa: F401  (save_graph, load_graph, save_walks re-exported)
    _PLAN_FIELDS,
    _WALK_FIELDS,
    _check_header,
    load_graph,
    save_graph,
    save_walks,
)
from telomeri_tpu.walk.plan import WalkPlan
from telomeri_tpu_torch.walk.engine import WalkResult


def load_walks(path: str, cfg: ScaffoldConfig | None = None
               ) -> tuple[WalkPlan, WalkResult]:
    """(plan, host numpy records) of a walks artifact; raises ValueError on a
    wrong kind or schema, warns where its config differs from cfg."""
    with np.load(path, allow_pickle=False) as z:
        _check_header(z["header"], "walks", cfg)
        plan = WalkPlan(**{f: z[f"plan_{f}"] for f in _PLAN_FIELDS})
        walks = WalkResult(**{f: z[f"walk_{f}"] for f in _WALK_FIELDS})
    return plan, walks

"""Monte-Carlo event resolution: the port of telomeri_tpu/walk/engine.py::_resolve_mc_events.

The all-MC scan (kernels/walk_scan.py) runs every walk for `max_steps` steps
past its end and streams out five (W, S) int32 records per step: nxt, total,
eid, adv, es_bits. Resolution finds each walk's first event and masks the rest:

  kill    total <= 0 (a dead row), or nxt equals an earlier node of the walk
          (start, nxt[0..t-1], -1 included: the cycle kill); an inactive walk
          is killed before step 0
  anchor  nxt < 2 * n_anchors; a kill at the same step wins
  n_taken = t_anchor + 1 on success, else min(t_kill, S); steps t < n_taken
  are taken, and the seven WalkResult fields follow: nodes (W, S+1) and eids
  (W, S) with -1 pads, steps, success, terminal (-1 unless success), path_len
  (int32 sum of adv), score_sum (float32 sum of ES in XLA's row-reduce order,
  kernels/walk_common.py sum_steps).

  - resolve_events_torch  plain torch version on any device: both revisit
                          branches of the reference (the packed sort while
                          n_nodes * mult < 2**31, else the pairwise test)
  - resolve_events_cuda   the hand-written kernel (csrc/walk_events.cu): a block
                          of up to 64 walks (fewer at long walks: their rows
                          fill its shared memory) moves its records as whole
                          spans, a thread finds its walk's first event (the
                          pairwise test, at any n_nodes) and sums its step ES
  - resolve_events        dispatch on the tensors' device

Each returns the seven fields as a tuple, in WalkResult's order
(walk/engine.py resolve_mc_events wraps them).
"""

from __future__ import annotations

import torch

from telomeri_tpu_torch.kernels import build
from telomeri_tpu_torch.kernels.walk_common import (check_steps, launch_on, sum_steps,
                                                    walk_outputs)
from telomeri_tpu_torch.utils.profiling import count, profiler_running, span


def _first_true(m: torch.Tensor, steps_i: torch.Tensor, big: int) -> torch.Tensor:
    return torch.where(m, steps_i, big).amin(dim=1)


def _check(start, active, planes, max_steps: int) -> int:
    """W of a resolution over five (W, S) int32 planes, all on one device."""
    if start.dim() != 1 or start.dtype != torch.int32:
        raise ValueError("start must be (W,) int32")
    w = start.shape[0]
    if active.shape != (w,) or active.dtype != torch.bool:
        raise ValueError("active must be (W,) bool")
    for name, a in zip(("nxts", "totals", "eids", "adv", "es_bits"), planes):
        if a.shape != (w, max_steps) or a.dtype != torch.int32:
            raise ValueError(f"{name} must be ({w}, {max_steps}) int32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    dev = start.device
    if any(t.device != dev for t in (active, *planes)):
        raise ValueError("start, active and the records must lie on one device")
    return w


def resolve_events_torch(start, active, nxts, totals, eids_new, adv_new, es_bits_new, *,
                         n_nodes: int, n_anchors: int, max_steps: int) -> tuple:
    """Plain torch version on any device, over (W, S) int32 per-step records:
    the first of dead row, revisit (cycle kill) or anchor hit ends the walk; a
    kill at the same step as an anchor hit wins. Both revisit branches of the
    reference: the packed sort when n_nodes * mult < 2**31, else pairwise."""
    w = start.shape[0]
    dev = start.device
    s_max = max_steps
    es_steps = es_bits_new.contiguous().view(torch.float32)
    seq = torch.cat([start[:, None], nxts], dim=1)                     # (W, S+1)
    steps_i = torch.arange(s_max, dtype=torch.int32, device=dev)[None, :].expand(w, s_max)
    big = s_max + 1
    mult = 64
    while mult < s_max + 1:
        mult *= 2
    if n_nodes * mult < 2**31:
        iota = torch.arange(s_max + 1, dtype=torch.int32, device=dev)[None, :]
        packed = torch.sort(seq * mult + iota, dim=1).values
        adj_eq = (torch.div(packed[:, 1:], mult, rounding_mode="floor")
                  == torch.div(packed[:, :-1], mult, rounding_mode="floor"))
        later = torch.remainder(packed[:, 1:], mult)
        t_rev = torch.where(adj_eq, later, big + 1).amin(dim=1) - 1
    else:   # node * mult would overflow int32: pairwise revisit test
        tri = (torch.arange(s_max + 1, device=dev)[None, :]
               <= torch.arange(s_max, device=dev)[:, None])           # (S, S+1)
        dup = ((nxts[:, :, None] == seq[:, None, :]) & tri[None]).any(-1)
        t_rev = _first_true(dup, steps_i, big)
    t_dead = _first_true(totals <= 0, steps_i, big)
    t_kill = torch.minimum(torch.where(active, big, 0).to(torch.int32),
                           torch.minimum(t_rev, t_dead))
    t_anchor = _first_true(nxts < 2 * n_anchors, steps_i, big)
    success = t_anchor < t_kill
    n_taken = torch.where(success, t_anchor + 1, torch.clamp_max(t_kill, s_max))
    at = torch.clamp(t_anchor, 0, s_max - 1).long()[:, None]
    terminal = torch.where(success, nxts.gather(1, at)[:, 0], -1)
    took = steps_i < n_taken[:, None]
    nodes = torch.cat([start[:, None], torch.where(took, nxts, -1)], dim=1)
    return (nodes,
            torch.where(took, eids_new, -1),
            n_taken.to(torch.int32),
            success,
            terminal.to(torch.int32),
            torch.where(took, adv_new, 0).sum(dim=1, dtype=torch.int32),
            sum_steps(torch.where(took, es_steps, 0.0)))


def resolve_events_cuda(start, active, nxts, totals, eids_new, adv_new, es_bits_new, *,
                        n_anchors: int, max_steps: int) -> tuple:
    """The CUDA kernel on CUDA tensors; launches on the current stream and
    raises if the launch fails. Returns what resolve_events_torch returns."""
    args = (start, active, nxts, totals, eids_new, adv_new, es_bits_new, n_anchors, max_steps)
    if not profiler_running():
        return _resolve_events_cuda(*args)
    with span("kernel.resolve_events"):
        return _resolve_events_cuda(*args)


def _resolve_events_cuda(start, active, nxts, totals, eids_new, adv_new, es_bits_new,
                         n_anchors: int, max_steps: int) -> tuple:
    planes = (nxts, totals, eids_new, adv_new, es_bits_new)
    w = _check(start, active, planes, max_steps)
    check_steps(max_steps)
    if start.device.type != "cuda":
        raise ValueError("resolve_events_cuda needs CUDA tensors")
    start, active = start.contiguous(), active.contiguous()
    planes = [a.contiguous() for a in planes]
    out = walk_outputs(start, w, max_steps)
    if w == 0:
        return out   # nothing to launch
    lib = build.load()
    args = (*[a.data_ptr() for a in planes], start.data_ptr(), active.data_ptr(),
            2 * int(n_anchors), w, max_steps, *[a.data_ptr() for a in out])
    build.check(launch_on(start.device, lambda stream: lib.telomeri_resolve_events(*args, stream)),
                "resolve_events")
    count("launch.resolve_events")
    return out


def resolve_events(start, active, nxts, totals, eids_new, adv_new, es_bits_new, *,
                   n_nodes: int, n_anchors: int, max_steps: int) -> tuple:
    """Dispatch on where the tensors lie: the plain version for CPU tensors,
    the kernel for CUDA tensors; it raises rather than fall back."""
    kind = start.device.type
    if kind == "cpu":
        _check(start, active, (nxts, totals, eids_new, adv_new, es_bits_new), max_steps)
        return resolve_events_torch(start, active, nxts, totals, eids_new, adv_new,
                                    es_bits_new, n_nodes=n_nodes, n_anchors=n_anchors,
                                    max_steps=max_steps)
    if kind == "cuda":
        return resolve_events_cuda(start, active, nxts, totals, eids_new, adv_new, es_bits_new,
                                   n_anchors=n_anchors, max_steps=max_steps)
    raise ValueError(f"no event-resolution path for device {start.device}")

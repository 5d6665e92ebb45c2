"""Greedy and mixed walk scan: the port of telomeri_tpu/walk/engine.py::_kind_core.

The scan advances every walk of a greedy section (kind "greedy") or of a plan
that is not sectioned (kind "mixed") through `max_steps` steps over the packed
(N, 6H) int32 walk table (kernels/walk_table.py), keeping each walk's path
(visited: start, then the node of each step taken, -1 elsewhere):

  greedy   valid = nbr >= 0 and nbr not on the path; the first maximum slot of
           a key that is OS for mode 0 and -j otherwise (-inf where not
           valid), in torch.argmax order; dead when no slot is valid
  mixed    the greedy rule for modes 0 and 1; for mode 2 (MC) the integer
           inverse-CDF draw of kernels/walk_scan.py (the same Threefry bits),
           dead on a dead row or when the drawn node is on the path
  step 0   a walk with first_edge >= 0 takes that slot, dead unless it is valid

A walk steps unless it is dead or done, and is done after a dead step or an
anchor hit (nxt < 2 * n_anchors: success). Outputs are the seven WalkResult
fields, as a tuple in its order: nodes (W, S+1) = the path, eids (W, S) with -1
pads, steps, success, terminal, path_len (int32 sum of adv), score_sum
(float32 sum of ES in XLA's row-reduce order, kernels/walk_common.py
sum_steps).

  - greedy_scan_torch  plain torch version on any device: a Python loop over
                       the steps (the reference's lax.scan); fetch(cur) ->
                       (W, 6H) rows, the local gather by default, the
                       collective fetch of dist/rowshard.py there
  - greedy_scan_cuda   the hand-written kernel (csrc/greedy_scan.cu): a warp a
                       walk, up to 4 a block (fewer at long walks: their paths
                       fill its shared memory), every step in one launch
  - greedy_scan        dispatch on the tensors' device (local fetch)
"""

from __future__ import annotations

import torch

from telomeri_tpu_torch.kernels import build
from telomeri_tpu_torch.kernels.walk_common import (check_steps, launch_on, stable_bits_table,
                                                    sum_steps, walk_outputs)
from telomeri_tpu_torch.kernels.walk_table import blocks, table_h
from telomeri_tpu_torch.utils.profiling import count, profiler_running, span
from telomeri_tpu_torch.walk.plan import MODE_GREEDY_OS, MODE_MC

KINDS = ("greedy", "mixed")   # csrc/greedy_scan.cu's kind argument: the index


def _pick(a: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """a[i, choice[i]], and 0 where choice is out of [0, K) (the reference's
    one-hot lane reduce)."""
    k = a.shape[1]
    inside = (choice >= 0) & (choice < k)
    v = a.gather(1, torch.clamp(choice, 0, k - 1).long()[:, None])[:, 0]
    return torch.where(inside, v, torch.zeros_like(v))


def _check(wide: torch.Tensor, pd, kind: str) -> tuple[int, int]:
    """(H, W) of a scan of the plan section pd over wide, all on one device."""
    if kind not in KINDS:
        raise ValueError(f"the greedy scan runs mixed or greedy sections, got {kind!r}")
    h = table_h(wide)
    w = pd.start.shape[0]
    for name in ("start", "first_edge", "mode", "uid"):
        a = getattr(pd, name)
        if a.shape != (w,) or a.dtype != torch.int32:
            raise ValueError(f"{name} must be ({w},) int32, got {tuple(a.shape)} {a.dtype}")
    if pd.active.shape != (w,) or pd.active.dtype != torch.bool:
        raise ValueError("active must be (W,) bool")
    dev = wide.device
    if any(a.device != dev for a in pd):
        raise ValueError("wide and the plan must lie on one device")
    return h, w


def greedy_scan_torch(wide: torch.Tensor, pd, seed, n_anchors: int, max_steps: int, kind: str,
                      fetch=None) -> tuple:
    """Plain torch version on any device: the mixed / greedy scan with the
    in-scan visited table, as a Python loop over steps. fetch(cur) -> (W, 6H)
    rows, as in kernels/walk_scan.py walk_scan_torch; the default is the local
    gather."""
    if kind not in KINDS:
        raise ValueError(f"_kind_core runs mixed or greedy sections, got {kind!r}")
    k = table_h(wide)
    if fetch is None:
        fetch = lambda cur: wide[cur.long()]
    w = pd.start.shape[0]
    dev = wide.device
    anchor_lim = 2 * n_anchors
    use_mc = kind == "mixed"
    bits = stable_bits_table(seed, pd.uid, max_steps) if use_mc else None
    is_mc = pd.mode == MODE_MC
    is_os = pd.mode == MODE_GREEDY_OS

    visited = torch.full((w, max_steps + 1), -1, dtype=torch.int32, device=dev)
    visited[:, 0] = pd.start
    cur = pd.start.clone()
    done = ~pd.active
    success = torch.zeros(w, dtype=torch.bool, device=dev)
    terminal = torch.full((w,), -1, dtype=torch.int32, device=dev)
    nsteps = torch.zeros(w, dtype=torch.int32, device=dev)
    ramp = -torch.arange(k, dtype=torch.float32, device=dev)[None, :].expand(w, k)
    took, eid_t, adv_t, es_t = [], [], [], []

    for s in range(max_steps):
        row = blocks(fetch(cur))                     # (W, 6H) one row fetch
        nbr_rows = row.nbr
        # greedy candidates exclude pads and already-visited destinations
        revisit = (nbr_rows[:, :, None] == visited[:, None, :]).any(-1)
        valid = (nbr_rows >= 0) & ~revisit
        osb = row.os_bits.contiguous().view(torch.float32)
        gkey = torch.where(is_os[:, None], osb, ramp)
        masked = torch.where(valid, gkey, float("-inf"))
        choice = torch.argmax(masked, dim=1).to(torch.int32)   # first max slot
        dead = ~valid.any(dim=1)
        if use_mc:
            total = row.cum[:, -1]
            r = torch.remainder(bits[s] & 0x7FFFFFFF, torch.clamp_min(total, 1))
            mc_choice = torch.clamp_max((row.cum <= r[:, None]).sum(1), k - 1).to(torch.int32)
            choice = torch.where(is_mc, mc_choice, choice)
            dead = torch.where(is_mc, total <= 0, dead)
        # deterministic first-edge enumeration (MC plans always have -1)
        forced = (pd.first_edge >= 0) if s == 0 else torch.zeros_like(dead)
        choice = torch.where(forced, pd.first_edge, choice)
        nxt = _pick(nbr_rows, choice)
        chosen_valid = _pick(valid.to(torch.int32), choice) > 0
        dead = torch.where(forced, ~chosen_valid, dead)
        if use_mc:   # MC cycle kill: the chosen destination is already on the path
            dead = dead | ((nxt[:, None] == visited).any(-1) & is_mc)

        stepping = ~done & ~dead
        hit_anchor = stepping & (nxt < anchor_lim)
        cur = torch.where(stepping, nxt, cur)
        done = done | dead | hit_anchor
        success = success | hit_anchor
        terminal = torch.where(hit_anchor, nxt, terminal)
        nsteps = nsteps + stepping.to(torch.int32)
        visited[:, s + 1] = torch.where(stepping, nxt, -1)
        took.append(stepping)
        eid_t.append(_pick(row.eid, choice))
        adv_t.append(_pick(row.adv, choice))
        es_t.append(_pick(row.es_bits, choice))

    took_ws = torch.stack(took, dim=1)
    es = torch.stack(es_t, dim=1).view(torch.float32)
    return (visited,
            torch.where(took_ws, torch.stack(eid_t, dim=1), -1),
            nsteps,
            success,
            terminal,
            torch.where(took_ws, torch.stack(adv_t, dim=1), 0).sum(dim=1, dtype=torch.int32),
            sum_steps(torch.where(took_ws, es, 0.0)))


def greedy_scan_cuda(wide: torch.Tensor, pd, seed, n_anchors: int, max_steps: int,
                     kind: str) -> tuple:
    """The CUDA kernel on CUDA tensors; launches on the current stream and
    raises if the launch fails. Returns what greedy_scan_torch returns with the
    local fetch."""
    if not profiler_running():
        return _greedy_scan_cuda(wide, pd, seed, n_anchors, max_steps, kind)
    with span("kernel.greedy_scan"):
        return _greedy_scan_cuda(wide, pd, seed, n_anchors, max_steps, kind)


def _greedy_scan_cuda(wide: torch.Tensor, pd, seed, n_anchors: int, max_steps: int,
                      kind: str) -> tuple:
    h, w = _check(wide, pd, kind)
    if h % 64:
        raise ValueError(f"the kernel needs H % 64 == 0, got H={h}")
    check_steps(max_steps)
    if wide.device.type != "cuda":
        raise ValueError("greedy_scan_cuda needs CUDA tensors")
    wide = wide.contiguous()
    if wide.data_ptr() % 16:
        raise ValueError("the kernel reads wide's rows 16 bytes at a time: it must "
                         "start on 16 bytes")
    plan = [getattr(pd, f).contiguous() for f in ("start", "first_edge", "mode", "uid", "active")]
    out = walk_outputs(plan[0], w, max_steps)
    if w == 0:
        return out   # nothing to launch
    lib = build.load()
    args = (wide.data_ptr(), h, int(wide.shape[0]), *[a.data_ptr() for a in plan],
            int(seed) & 0xFFFFFFFF, 2 * int(n_anchors), KINDS.index(kind), w, max_steps,
            *[a.data_ptr() for a in out])
    build.check(launch_on(wide.device, lambda stream: lib.telomeri_greedy_scan(*args, stream)),
                "greedy_scan")
    count("launch.greedy_scan")
    return out


def greedy_scan(wide: torch.Tensor, pd, seed, n_anchors: int, max_steps: int,
                kind: str) -> tuple:
    """Dispatch on where the tensors lie, with the local row fetch: the plain
    version for CPU tensors, the kernel for CUDA tensors; it raises rather than
    fall back."""
    dev = wide.device.type
    if dev == "cpu":
        _check(wide, pd, kind)
        return greedy_scan_torch(wide, pd, seed, n_anchors, max_steps, kind)
    if dev == "cuda":
        return greedy_scan_cuda(wide, pd, seed, n_anchors, max_steps, kind)
    raise ValueError(f"no greedy-scan path for device {wide.device}")

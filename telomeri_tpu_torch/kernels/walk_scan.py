"""All-Monte-Carlo walk scan: the port of telomeri_tpu/kernels/walk_vmem.py::_walk_kernel.

The scan advances every walk of an all-MC plan section through `max_steps`
steps over the packed (N, 6H) int32 walk table (kernels/walk_table.py) and
streams out five per-step records, each (W, S) int32:

  nxt    neighbour id at the sampled slot (-1 at a pad slot)
  total  the row's weight total cum[H-1] (<= 0: a dead row)
  eid    edge id at the slot
  adv    path-length advance (bp) at the slot
  es     ES score float32 bits at the slot

Per step: r = (bits & 0x7FFFFFFF) % max(total, 1) in int32, slot =
min(#{j : cum[j] <= r}, H-1), and the walk moves to nxt when nxt >= 0. It is
historyless (MC draws never consult the path); walk/engine.py resolve_mc_events
finds each walk's first event from the records afterwards. `bits` of step s of
walk `uid` is word s % 2 of Threefry-2x32 block s // 2 under the key
fold_in(key(seed), uid) (kernels/walk_common.py stable_bits_table).

  - walk_scan_torch  plain torch version over a given (S, W) bits table (the
                     lax.scan of the reference's _mc_fast_core, one row fetch
                     per step); dist/rowshard.py runs it with a collective fetch
  - walk_scan_cuda   the hand-written kernel (csrc/walk_scan.cu): a sub-warp per
                     walk, the Threefry draw computed in registers, so no bits
                     table exists on its path; it reads the cum block from
                     `wide` and the pick from the pick plane
  - walk_scan        (wide, start, uid, seed, S, picks=None): dispatch on the
                     tensors' device

Records come back as one (5, W, S) int32 tensor in the order above.

The kernel picks from the table's pick plane (kernels/walk_table.py
pick_plane), which GraphDev builds once and hands to every later scan; the
kernel wrapper builds one for the call where none is passed. The plain version
reads `wide` alone and never builds one.
"""

from __future__ import annotations

import torch

from telomeri_tpu_torch.kernels import build
from telomeri_tpu_torch.kernels.walk_common import stable_bits_table
from telomeri_tpu_torch.kernels.walk_table import (PICKED_BLOCKS, blocks, pick_plane,
                                                   plane_shape, table_h)
from telomeri_tpu_torch.utils.profiling import count, profiler_running, span


def _check(wide: torch.Tensor, start: torch.Tensor, per_walk: torch.Tensor, name: str,
           shape: tuple) -> tuple[int, int]:
    """(H, W) of a scan over `wide` from `start`, with the draw input `per_walk`
    (the bits table or the uids) of the given shape, all int32 on one device."""
    h = table_h(wide)
    if start.dim() != 1 or start.dtype != torch.int32:
        raise ValueError("start must be (W,) int32")
    if tuple(per_walk.shape) != shape or per_walk.dtype != torch.int32:
        raise ValueError(f"{name} must be {shape} int32, got "
                         f"{tuple(per_walk.shape)} {per_walk.dtype}")
    if not (wide.device == start.device == per_walk.device):
        raise ValueError(f"wide, start and {name} must lie on one device")
    return h, start.shape[0]


def walk_scan_torch(wide: torch.Tensor, start: torch.Tensor, bits: torch.Tensor,
                    max_steps: int, fetch=None) -> torch.Tensor:
    """Plain torch version on any device. bits: (S, W) int32 holding the uint32
    draw bit patterns (kernels/walk_common.py stable_bits_table).

    fetch(cur) -> (W, 6H) rows of the walks' current nodes; the default is the
    local gather wide[cur]. dist/rowshard.py passes a collective fetch, with
    `wide` then this rank's shard of the table."""
    h, w = _check(wide, start, bits, "bits", (max_steps, start.shape[0]))
    if fetch is None:
        fetch = lambda cur: wide[cur.long()]
    out = torch.empty((5, w, max_steps), dtype=torch.int32, device=wide.device)
    cur = start.clone()
    for s in range(max_steps):
        row = blocks(fetch(cur))                      # (W, 6H) one row fetch
        total = row.cum[:, -1]
        r = torch.remainder(bits[s] & 0x7FFFFFFF, torch.clamp_min(total, 1))
        choice = torch.clamp_max((row.cum <= r[:, None]).sum(1), h - 1)[:, None]
        nxt, eid, adv, es = (row[b].gather(1, choice)[:, 0] for b in PICKED_BLOCKS)
        out[:, :, s] = torch.stack([nxt, total, eid, adv, es])
        cur = torch.where(nxt >= 0, nxt, cur)
    return out


def walk_scan_cuda(wide: torch.Tensor, start: torch.Tensor, uid: torch.Tensor, seed: int,
                   max_steps: int, picks: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors; launches on the current stream and
    raises if the launch fails. Returns what walk_scan_torch returns over
    stable_bits_table(seed, uid, max_steps). picks: pick_plane(wide), built
    for this call when None."""
    if not profiler_running():
        return _walk_scan_cuda(wide, start, uid, seed, max_steps, picks)
    with span("kernel.walk_scan"):
        return _walk_scan_cuda(wide, start, uid, seed, max_steps, picks)


def _walk_scan_cuda(wide: torch.Tensor, start: torch.Tensor, uid: torch.Tensor, seed: int,
                    max_steps: int, picks: torch.Tensor | None) -> torch.Tensor:
    h, w = _check(wide, start, uid, "uid", tuple(start.shape))
    if wide.device.type != "cuda":
        raise ValueError("walk_scan_cuda needs CUDA tensors")
    if h % 64:
        raise ValueError(f"the kernel needs H % 64 == 0, got H={h}")
    if picks is None:
        picks = pick_plane(wide)
    elif (tuple(picks.shape) != plane_shape(wide.shape[0], h) or picks.dtype != torch.int32
          or picks.device != wide.device):
        raise ValueError(f"picks must be {plane_shape(wide.shape[0], h)} int32 on {wide.device}, "
                         f"got {tuple(picks.shape)} {picks.dtype} on {picks.device}")
    wide, picks, start, uid = (t.contiguous() for t in (wide, picks, start, uid))
    lib = build.load()
    with torch.cuda.device(wide.device):
        out = torch.empty((5, w, max_steps), dtype=torch.int32, device=wide.device)
        if w == 0 or max_steps == 0:
            return out   # nothing to launch
        rc = lib.telomeri_walk_scan(
            wide.data_ptr(), picks.data_ptr(), h, start.data_ptr(), uid.data_ptr(),
            int(seed) & 0xFFFFFFFF, w, max_steps, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "walk_scan")
    count("launch.walk_scan")
    return out


def walk_scan(wide: torch.Tensor, start: torch.Tensor, uid: torch.Tensor, seed: int,
              max_steps: int, picks: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch on where the tensors lie: the draw table and the plain version
    for CPU tensors (which reads `wide` alone: `picks` is not used there), the
    kernel (which draws for itself) for CUDA tensors, reading the pick plane
    `picks` (pick_plane(wide), built for the call when None); it raises
    rather than fall back."""
    kind = wide.device.type
    if kind == "cpu":
        _check(wide, start, uid, "uid", tuple(start.shape))
        return walk_scan_torch(wide, start, stable_bits_table(seed, uid, max_steps), max_steps)
    if kind == "cuda":
        return walk_scan_cuda(wide, start, uid, seed, max_steps, picks)
    raise ValueError(f"no walk-scan path for device {wide.device}")

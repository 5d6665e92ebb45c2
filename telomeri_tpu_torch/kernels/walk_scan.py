"""All-Monte-Carlo walk scan: the port of telomeri_tpu/kernels/walk_vmem.py::_walk_kernel.

The scan advances every walk of an all-MC plan section through `max_steps`
steps over the packed (N, 6H) int32 walk table (walk/engine.py GraphDev) and
streams out five per-step records, each (W, S) int32:

  nxt    neighbour id at the sampled slot (-1 at a pad slot)
  total  the row's weight total cum[H-1] (<= 0: a dead row)
  eid    edge id at the slot
  adv    path-length advance (bp) at the slot
  es     ES score float32 bits at the slot

Per step: r = (bits & 0x7FFFFFFF) % max(total, 1) in int32, slot =
min(#{j : cum[j] <= r}, H-1), and the walk moves to nxt when nxt >= 0. It is
historyless (MC draws never consult the path); walk/engine.py resolve_mc_events
finds each walk's first event from the records afterwards.

  - walk_scan_torch  plain torch version (the lax.scan of the reference's
                     _mc_fast_core, one row gather per step)
  - walk_scan_cuda   the hand-written kernel (csrc/walk_scan.cu): one warp per
                     walk, bound by the latency of the dependent row gather
  - walk_scan        dispatch on the tensors' device

Records come back as one (5, W, S) int32 tensor in the order above.
"""

from __future__ import annotations

import torch

from telomeri_tpu_torch.kernels import build

# launches of the kernel; only walk_scan_cuda adds to it
launches = {"walk_scan": 0}


def _check(wide: torch.Tensor, start: torch.Tensor, bits: torch.Tensor,
           max_steps: int) -> tuple[int, int]:
    if wide.dim() != 2 or wide.shape[1] % 6 or wide.dtype != torch.int32:
        raise ValueError(f"wide must be (N, 6H) int32, got {tuple(wide.shape)} {wide.dtype}")
    h = wide.shape[1] // 6
    w = start.shape[0]
    if start.dim() != 1 or start.dtype != torch.int32:
        raise ValueError("start must be (W,) int32")
    if tuple(bits.shape) != (max_steps, w) or bits.dtype != torch.int32:
        raise ValueError(f"bits must be ({max_steps}, {w}) int32, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if not (wide.device == start.device == bits.device):
        raise ValueError("wide, start and bits must lie on one device")
    return h, w


def walk_scan_torch(wide: torch.Tensor, start: torch.Tensor, bits: torch.Tensor,
                    max_steps: int, fetch=None) -> torch.Tensor:
    """Plain torch version on any device. bits: (S, W) int32 holding the uint32
    draw bit patterns (walk/engine.py stable_bits_table).

    fetch(cur) -> (W, 6H) rows of the walks' current nodes; the default is the
    local gather wide[cur]. dist/rowshard.py passes a collective fetch, with
    `wide` then this rank's shard of the table."""
    h, w = _check(wide, start, bits, max_steps)
    if fetch is None:
        fetch = lambda cur: wide[cur.long()]
    out = torch.empty((5, w, max_steps), dtype=torch.int32, device=wide.device)
    # column of the chosen slot in each picked block: nbr, eid, adv, es_bits
    blocks = torch.tensor([0, 2 * h, 3 * h, 4 * h], dtype=torch.int64,
                          device=wide.device)
    cur = start.clone()
    for s in range(max_steps):
        rows = fetch(cur)                             # (W, 6H) one row fetch
        cum = rows[:, h:2 * h]
        total = cum[:, -1]
        r = torch.remainder(bits[s] & 0x7FFFFFFF, torch.clamp_min(total, 1))
        choice = torch.clamp_max((cum <= r[:, None]).sum(1), h - 1)
        picked = rows.gather(1, choice[:, None] + blocks[None, :])   # (W, 4)
        nxt = picked[:, 0]
        out[0, :, s] = nxt
        out[1, :, s] = total
        out[2:, :, s] = picked[:, 1:].T
        cur = torch.where(nxt >= 0, nxt, cur)
    return out


def walk_scan_cuda(wide: torch.Tensor, start: torch.Tensor, bits: torch.Tensor,
                   max_steps: int) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors; launches on the current stream and
    raises if the launch fails. Returns what walk_scan_torch does."""
    h, w = _check(wide, start, bits, max_steps)
    if wide.device.type != "cuda":
        raise ValueError("walk_scan_cuda needs CUDA tensors")
    if h % 32:
        raise ValueError(f"the kernel needs H % 32 == 0, got H={h}")
    wide, start, bits = (t.contiguous() for t in (wide, start, bits))
    lib = build.load()
    with torch.cuda.device(wide.device):
        out = torch.empty((5, w, max_steps), dtype=torch.int32, device=wide.device)
        rc = lib.telomeri_walk_scan(
            wide.data_ptr(), h, start.data_ptr(), bits.data_ptr(), w, max_steps,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        build.check(rc, "walk_scan")
    launches["walk_scan"] += 1
    return out


def walk_scan(wide: torch.Tensor, start: torch.Tensor, bits: torch.Tensor,
              max_steps: int) -> torch.Tensor:
    """Dispatch on where the tensors lie: the plain version for CPU tensors, the
    kernel for CUDA tensors (it raises rather than fall back)."""
    kind = wide.device.type
    if kind == "cpu":
        return walk_scan_torch(wide, start, bits, max_steps)
    if kind == "cuda":
        return walk_scan_cuda(wide, start, bits, max_steps)
    raise ValueError(f"no walk-scan path for device {wide.device}")

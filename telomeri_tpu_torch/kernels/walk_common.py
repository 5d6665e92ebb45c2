"""What the walk kernels' wrappers share, the Python side of csrc/walk_common.cuh.

  - threefry2x32, stable_bits_table  the MC draw, which the kernels make in
                registers, as an (S, W) table in uint32 arithmetic on int64
                tensors (torch.Generator does not produce jax.random's stream)
  - sum_steps   the float32 step sum in XLA CPU's row-reduce order, which the
                kernels compute one step at a time (walk_common.cuh StepSum)
                and the plain versions compute here, on any device
  - MAX_STEPS   the most steps the greedy-scan and event-resolution kernels
                take: StepSum has three levels of 32-wide windows. Each kernel
                sizes its blocks' shared memory from the step count, so every
                count up to this one launches
  - walk_outputs, launch_on  what both kernels' wrappers do around the ctypes
                call: the seven WalkResult outputs, and the launch with the
                tensors' device current, on its current stream
"""

from __future__ import annotations

import torch

SUM_WINDOW = 32   # XLA CPU's tree-reduction window (sum_steps)
MAX_STEPS = SUM_WINDOW ** 3
_M32 = 0xFFFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, as jax.random's threefry_2x32: key (k0, k1),
    counters (x0, x1). uint32 values in int64 tensors (or ints) that broadcast;
    every sum is masked back to 32 bits, so nothing overflows int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def stable_bits_table(seed: int, uid: torch.Tensor, max_steps: int) -> torch.Tensor:
    """(S, W) int32 table of per-step MC draw bits (uint32 bit patterns).

    The port of the reference's _stable_bits_table: key(seed) is (0, seed) as in
    jax.random with x64 off (the seed is an int32), fold_in(key, uid) hashes the
    counter pair (0, uid), and block b hashes the FIXED counters (2b, 2b+1), so
    step s = lane s % 2 of block s // 2 and the stream is a stable prefix in
    max_steps."""
    n_blocks = (max_steps + 1) // 2
    dev = uid.device
    k0, k1 = threefry2x32(0, int(seed) & _M32, 0, uid.to(torch.int64) & _M32)
    b = torch.arange(n_blocks, dtype=torch.int64, device=dev)[None, :]
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], 2 * b, 2 * b + 1)   # (W, B)
    bits = torch.stack([y0, y1], dim=2).reshape(uid.shape[0], 2 * n_blocks)
    bits = bits[:, :max_steps].T                                        # (S, W)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).contiguous()


def sum_steps(x: torch.Tensor) -> torch.Tensor:
    """(W, S) float32 -> (W,), in XLA CPU's row-reduce order: up to 32 steps one
    sequential sum from +0.0; above, the steps zero-padded to a multiple of 32
    (pad // 2 in front), each window summed so, and the window sums reduced by
    the same rule. Plain float32 adds in a fixed order, the same on every device."""
    w, s = x.shape
    if s > SUM_WINDOW:
        n_win = -(-s // SUM_WINDOW)
        pad = n_win * SUM_WINDOW - s
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(w, n_win, SUM_WINDOW)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return sum_steps(acc) if acc.dim() == 2 else acc


def check_steps(max_steps: int) -> None:
    """Raise unless a walk kernel takes max_steps."""
    if not 1 <= max_steps <= MAX_STEPS:
        raise ValueError(f"the walk kernels take 1 <= max_steps <= {MAX_STEPS}, got {max_steps}")


def walk_outputs(like: torch.Tensor, w: int, s: int) -> tuple:
    """Uninitialised WalkResult outputs of w walks of s steps on the device of
    `like` (an int32 tensor), in its order: nodes (W, S+1), eids (W, S), steps,
    success (bool), terminal, path_len, score_sum (float32)."""
    return (like.new_empty((w, s + 1)), like.new_empty((w, s)), like.new_empty(w),
            like.new_empty(w, dtype=torch.bool), like.new_empty(w), like.new_empty(w),
            like.new_empty(w, dtype=torch.float32))


def launch_on(device: torch.device, launch) -> int:
    """launch(stream) with `device` the current CUDA device (the runtime
    launches there) and its current stream's handle; the device context is
    entered only where another device is current. Returns what launch does."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream(device).cuda_stream)

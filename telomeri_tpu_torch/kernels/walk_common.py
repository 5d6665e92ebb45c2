"""What the walk kernels' wrappers share, the Python side of csrc/walk_common.cuh.

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

SUM_WINDOW = 32   # XLA CPU's tree-reduction window (walk/engine.py docstring)
MAX_STEPS = SUM_WINDOW ** 3


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

"""The chip's peaks and the bytes and operations a walk kernel's call needs.

A share of a roofline is the least time the chip could take for the work,
over the time the kernel took: the larger of its bytes over the memory rate
and its operations over the peak rate. Bytes count each needed input read once
and each output written once, for what these inputs need (a walk that ends
early needs no more of its records), never the most they could. The counts
are those of the program's own chip_smoke.py "Bound" column, kept here so that
later changes to the program cannot move them.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # non-tensor float32 rate, taken for int32 too


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(seconds, what binds) of the least time for n_bytes and n_ops."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_output_bytes(w: int, s: int) -> int:
    """nodes (S+1) and eids (S) int32, steps, terminal, path_len int32,
    score_sum float32 and success one byte, for w walks."""
    return w * ((2 * s + 1) * 4 + 17)


def scan_need(w: int, s: int, h: int, rows_visited: int, picks: int) -> tuple[int, int]:
    """(bytes, operations) of one all-MC scan: start and uid read once, the cum
    block (H words) of every distinct row visited, the four picked words (nbr,
    eid, adv, es) of every distinct (row, slot) picked, the five (W, S) records
    written once; H compares and half a Threefry block (about 60 integer
    operations) a walk and step."""
    return 8 * w + rows_visited * 4 * h + picks * 16 + 5 * w * s * 4, w * s * (h + 60)


def resolve_need(w: int, s: int, steps: torch.Tensor, success: torch.Tensor,
                 active: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) of one event resolution: start and active read once;
    of each active walk nxt and total up to and including its first event, and
    eid, adv and es of its taken steps; the outputs written once; a revisit
    test against every earlier node of the steps read."""
    steps = steps.long()
    reads = torch.where(active, torch.where(success, steps, torch.clamp(steps + 1, max=s)), 0)
    n_bytes = 5 * w + 8 * int(reads.sum()) + 12 * int(steps.sum()) + walk_output_bytes(w, s)
    return n_bytes, int((reads * (reads + 1) // 2).sum())


def resolve_all_planes_bytes(w: int, s: int) -> int:
    """The same call if it read every record once."""
    return 5 * w + 5 * 4 * w * s + walk_output_bytes(w, s)


class ScanCounter:
    """Distinct rows visited and distinct (row, slot) picks of one scan, fed a
    block of walks at a time: rows (B, S) fetched at each step and the eid
    record (B, S) of the slot picked there (an edge id names its slot)."""

    def __init__(self, n_nodes: int, device):
        self.rows = torch.zeros(n_nodes, dtype=torch.bool, device=device)
        self.picks: list[torch.Tensor] = []

    def add(self, rows: torch.Tensor, eids: torch.Tensor) -> None:
        self.rows[rows.reshape(-1)] = True
        key = rows.reshape(-1) * 2**32 + (eids.reshape(-1).long() & 0xFFFFFFFF)
        self.picks.append(torch.unique(key))

    def counts(self) -> tuple[int, int]:
        picks = int(torch.unique(torch.cat(self.picks)).numel()) if self.picks else 0
        return int(self.rows.sum()), picks

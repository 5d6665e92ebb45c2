"""The device walk table's format: the one module that knows it.

A graph's walk table is one (N, 6H) int32 tensor (the reference's packed
GraphDev.wide), a row per oriented node and six column blocks of H =
lane_width(K) slots each, in the order BLOCKS: neighbour id, the running sum
of the slots' MC weights, edge id, path-length advance (bp), and the ES and OS
scores as float32 bits. A slot past the graph's K holds PAD, except that cum
pads carry the row total. On a card the MC kernel also reads the table's pick
plane (pick_plane). device_walk_bytes counts both from the shapes they are
allocated with.
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from telomeri_tpu_torch.graph.tensorize import GraphTensors
from telomeri_tpu_torch.utils.profiling import count, count_copy, span

BLOCKS = ("nbr", "cum", "eid", "adv", "es_bits", "os_bits")
PAD = dict(nbr=-1, cum=0, eid=-1, adv=0, es_bits=0, os_bits=0)   # cum: see pack_wide
# the blocks a step picks from, in the pick plane's order
PICKED_BLOCKS = tuple(BLOCKS.index(b) for b in ("nbr", "eid", "adv", "es_bits"))

count("walk.pick_plane_builds", 0)
count("bytes.pick_plane", 0)


Blocks = namedtuple("Blocks", BLOCKS)


def blocks(rows) -> Blocks:
    """Named views of the blocks of (..., 6H) int32 rows, a numpy array or a
    tensor: writing to a view writes to `rows`."""
    h = rows.shape[-1] // len(BLOCKS)
    return Blocks(*(rows[..., i * h:(i + 1) * h] for i in range(len(BLOCKS))))


def lane_width(k: int) -> int:
    """Padded CSR half-width H: the smallest of 64, 128, 256, ... >= k."""
    h = 64
    while h < k:
        h *= 2
    return h


def table_shape(n: int, h: int) -> tuple[int, int]:
    return n, len(BLOCKS) * h


def plane_shape(n: int, h: int) -> tuple[int, int, int]:
    return n, h, len(PICKED_BLOCKS)


def nbytes(shape: tuple) -> int:
    """Bytes of an int32 array of `shape`."""
    return math.prod(shape) * np.dtype(np.int32).itemsize


def table_h(wide: torch.Tensor) -> int:
    """H of an (N, 6H) int32 walk table; ValueError for anything else."""
    if wide.dim() != 2 or wide.shape[1] % len(BLOCKS) or wide.dtype != torch.int32:
        raise ValueError(f"wide must be (N, 6H) int32, got {tuple(wide.shape)} {wide.dtype}")
    return wide.shape[1] // len(BLOCKS)


# --- host-side packing (numpy copies of the reference's helpers) ----------------

def mc_weights(es: np.ndarray) -> np.ndarray:
    """Integer MC sampling weights: ceil(ES) for ES > 0 (at least 1), else 0."""
    es = np.asarray(es, np.float32)
    return np.where(es > 0, np.maximum(np.ceil(es), 1), 0).astype(np.int32)


def mc_weights_torch(es: torch.Tensor) -> torch.Tensor:
    """mc_weights of float32 ES on the tensor's device."""
    return torch.where(es > 0, torch.clamp_min(torch.ceil(es), 1.0), 0.0).to(torch.int32)


def cum_weights(g: GraphTensors) -> np.ndarray:
    """(N, K) int32 running sums of the graph's MC weights (its cumw if it has one)."""
    if g.cumw is not None:
        return g.cumw
    return np.cumsum(mc_weights(g.es), axis=1, dtype=np.int64).astype(np.int32)


def pack_wide(nbr, cumw, eid, adv, es, os_, h: int) -> np.ndarray:
    """Pack the (N, K) CSR tables into the (N, 6H) wide rows, PAD past each
    table's K columns; cum pads carry the row total, so the compare-count never
    lands on them."""
    cols = (nbr, cumw, eid, adv, np.asarray(es).astype(np.float32).view(np.int32),
            np.asarray(os_).astype(np.float32).view(np.int32))
    wide = np.empty(table_shape(len(nbr), h), np.int32)
    for view, name, a in zip(blocks(wide), BLOCKS, cols):
        a = np.asarray(a)
        k = a.shape[1]
        view[:, :k] = a
        view[:, k:] = a[:, -1:] if name == "cum" and k else PAD[name]
    return wide


def dead_rows(n: int, h: int) -> np.ndarray:
    """n rows of pads alone, whose total is 0: the row-sharded placement's padding."""
    none = np.zeros((n, 0), np.int32)
    return pack_wide(none, none, none, none, none, none, h)


# --- on a device -------------------------------------------------------------------

def pick_plane(wide: torch.Tensor) -> torch.Tensor:
    """(N, H, 4) int32 pick plane of the (N, 6H) table on its device: entry [v, j]
    is slot j of node v's words of the PICKED_BLOCKS, pads included, so the four
    words an MC step picks are one 16-byte sector instead of four sectors in
    four blocks of the row. One plain copy (torch.stack of strided views) in
    the span walk.pick_plane; counts walk.pick_plane_builds and bytes.pick_plane."""
    h = table_h(wide)
    b = blocks(wide)
    with span("walk.pick_plane", N=wide.shape[0], H=h):
        plane = torch.stack([b[i] for i in PICKED_BLOCKS], dim=2,
                            out=wide.new_empty(plane_shape(wide.shape[0], h)))
    count("walk.pick_plane_builds")
    count("bytes.pick_plane", plane.nbytes)
    return plane


class GraphDev:
    """Device-resident packed walk table (see the reference's GraphDev).

    wide: the (N, 6H) int32 table. picks: its pick plane, built on the first
    read (on a card, the first MC scan) and kept for the table's life. So
    `wide` is read-only and not to be edited in place: a new table is a new
    GraphDev."""

    __slots__ = ("_wide", "_picks")

    def __init__(self, wide: torch.Tensor):
        self._wide = wide
        self._picks: torch.Tensor | None = None

    @property
    def wide(self) -> torch.Tensor:
        return self._wide

    @property
    def h(self) -> int:
        return self.wide.shape[1] // len(BLOCKS)

    @property
    def picks(self) -> torch.Tensor:
        if self._picks is None:
            self._picks = pick_plane(self.wide)
        return self._picks


def graph_to_device(g: GraphTensors, device) -> GraphDev:
    h = lane_width(g.nbr.shape[1])
    with span("walk.pack", N=g.nbr.shape[0], H=h):
        wide = pack_wide(g.nbr, cum_weights(g), g.eid, g.adv, g.es, g.os_, h)
    with span("walk.upload", N=g.nbr.shape[0], H=h):
        gd = GraphDev(wide=torch.from_numpy(wide).to(device))
    count_copy([gd.wide], "cpu", device)
    return gd


def device_table_bytes(g: GraphTensors) -> int:
    """Bytes of the packed walk table of g on a device."""
    return nbytes(table_shape(g.nbr.shape[0], lane_width(g.nbr.shape[1])))


def device_walk_bytes(g: GraphTensors, device) -> int:
    """Bytes of the walk stage's tables on `device`: the packed table, and on a
    card also the pick plane GraphDev.picks builds beside it."""
    plane = nbytes(plane_shape(g.nbr.shape[0], lane_width(g.nbr.shape[1])))
    return device_table_bytes(g) + (plane if torch.device(device).type == "cuda" else 0)

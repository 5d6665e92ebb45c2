"""The device walk table's format: the one module that knows it.

A graph's walk table is one (N, 6H) int32 tensor (the reference's packed
GraphDev.wide), a row per oriented node and six column blocks of H =
lane_width(K) slots each, in the order BLOCKS: neighbour id, the running sum
of the slots' MC weights, edge id, path-length advance (bp), and the ES and OS
scores as float32 bits. A slot past the graph's K holds PAD, except that cum
pads carry the row total. On a card the MC kernel also reads the table's pick
plane (pick_plane), whose entries carry their destination row's header
(row_header). device_walk_bytes counts both from the shapes they are allocated
with.
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
# the blocks a step picks from, in the pick plane's order: words 0-3 of an entry
PICKED_BLOCKS = tuple(BLOCKS.index(b) for b in ("nbr", "eid", "adv", "es_bits"))
# words 4-5 of an entry: row_header of the row the pick leads to; 6-7 are 0
PLANE_WORDS = 8   # 32 bytes, one sector
# rows x H entries of the plane built at a time: bounds the build's temporaries
PLANE_BUILD_ENTRIES = 2**23

count("walk.pick_plane_builds", 0)
count("bytes.pick_plane", 0)
count("walk.cum_span_words", 0)


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
    return n, h, PLANE_WORDS


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

def row_header(cum: torch.Tensor) -> torch.Tensor:
    """(R, 2) int32 {total, span} of (R, H) int32 cum rows. total = cum[H-1].
    span = 1 + max{j : cum[j] < total} (0 where there is none), or H where
    total <= 0. An MC step draws 0 <= r < total, so every word at j >= span is
    >= total > r and never counted: a step that knows the span reads only
    cum[:span] and picks the same slot, on any int32 row (pads, zero weights,
    wrapped or non-monotone sums). A dead row (total <= 0) reads its whole
    block, as r = 0 may count any word there."""
    h = cum.shape[1]
    total = cum[:, -1]
    j = torch.arange(1, h + 1, dtype=torch.int32, device=cum.device)
    span = torch.where(cum < total[:, None], j, 0).amax(1)
    span = torch.where(total > 0, span, h)
    return torch.stack([total, span], dim=1)


def pick_plane(wide: torch.Tensor) -> torch.Tensor:
    """(N, H, 8) int32 pick plane of the (N, 6H) table on its device. Entry
    [v, j]: words 0-3 slot j of node v's words of the PICKED_BLOCKS, pads
    included, so the four words an MC step picks are one sector instead of
    four sectors in four blocks of the row; words 4-5 row_header of u = nbr
    (v itself at a pad, where the walk stays put), so the next step knows its
    row's total and span before it reads the cum block; words 6-7 zero.
    Built in blocks of rows, in the span walk.pick_plane; counts
    walk.pick_plane_builds, bytes.pick_plane and walk.cum_span_words (the
    sum of the rows' spans: over N x H, the share of the cum words a step
    reads)."""
    h = table_h(wide)
    n = wide.shape[0]
    b = blocks(wide)
    rows = max(1, PLANE_BUILD_ENTRIES // h)
    with span("walk.pick_plane", N=n, H=h):
        plane = wide.new_empty(plane_shape(n, h))
        head = wide.new_empty((n, 2))
        for i in range(0, n, rows):
            head[i:i + rows] = row_header(b.cum[i:i + rows])
        words = head.view(torch.int64)[:, 0]   # a row's {total, span} as one 8-byte word
        zero = wide.new_zeros(())
        for i in range(0, n, rows):
            picked = [b[block][i:i + rows] for block in PICKED_BLOCKS]
            nbr = picked[0]
            v = torch.arange(i, i + nbr.shape[0], dtype=torch.int32, device=wide.device)
            dest = words[torch.where(nbr >= 0, nbr, v[:, None])].view(torch.int32)  # (rows, 2H)
            torch.stack([*picked, dest[:, 0::2], dest[:, 1::2], *[zero.expand_as(nbr)] * 2],
                        dim=2, out=plane[i:i + rows])
        spans = int(head[:, 1].sum(dtype=torch.int64))
    count("walk.pick_plane_builds")
    count("bytes.pick_plane", plane.nbytes)
    count("walk.cum_span_words", spans)
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
